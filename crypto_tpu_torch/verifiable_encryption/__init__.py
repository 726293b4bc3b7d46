"""Verifiable encryption (reference `verifiable_encryption/`): TZ21
DKG-in-the-head (`tz21.py`) and its robust variant (`rdkgith.py`)."""
