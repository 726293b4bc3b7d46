"""Short group signatures of the port: weak Boneh-Boyen (`weak_bb`) and
full Boneh-Boyen (`bb_sig`) signatures with their pairing-free-prover
proofs of knowledge, counterparts of `crypto_tpu/short_group_sig/`."""
