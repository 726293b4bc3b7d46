"""BBS# — KVAC over a pairing-free curve (secp256r1) with hardware-bound
presentation (Schnorr or ECDSA secure-element signatures) and half-offline
issuance tokens (reference `kvac/src/bbs_sharp/`).

The port's own copy of `crypto_tpu/kvac/bbs_sharp/__init__.py`; host
code (no device field is built for secp256r1)."""

from .hol import (HOLSignerProtocol, HOLUserProtocol, PreChallengeData,
                  ProofOfValidity, TokenPrivateData)
from .mac import MAC, ProofOfValidityOfMAC
from .proof import (ECDSA, SCHNORR, KeyedProofBBSSharp, PoKOfMAC,
                    PoKOfMACProtocol)
from .setup import (DesignatedVerifierPoKOfPublicKey, MACParams, SecretKey,
                    SignerPublicKey, UserPublicKey)
