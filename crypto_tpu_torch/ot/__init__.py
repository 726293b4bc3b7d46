"""Oblivious transfer: base OTs (Simplest, Naor-Pinkas, Endemic), the
ALSZ/KOS OT extension, Gilboa and DKLS18/19 two-party multiplication,
coin tossing and zero sharing.  Host work: hashing, AES and scalar
multiplications on the host's integers."""
