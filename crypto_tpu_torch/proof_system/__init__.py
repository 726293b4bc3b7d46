"""The composite proof system of the port, counterpart of
`crypto_tpu/proof_system/`: statements of several primitives (BBS+
signatures, VB and KB accumulators, Pedersen commitments, SAVER
verifiable encryption, LegoGroth16 bound checks) proved under one
Fiat-Shamir transcript, with witness equalities across them, and
verified with one shared `RandomizedPairingChecker` whose lazy Miller
product runs on the device."""
