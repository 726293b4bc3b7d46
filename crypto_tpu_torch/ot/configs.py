"""OT configuration objects (reference
`oblivious_transfer/src/configs.rs:12-45`): small validated structs that
describe how many OTs run and with how many messages each.  The port's
copy of `crypto_tpu/ot/configs.py`."""

from __future__ import annotations

from dataclasses import dataclass


class OTConfigError(Exception):
    pass


@dataclass(frozen=True)
class OTConfig:
    num_ot: int
    num_messages: int = 2     # n in a 1-of-n OT

    def __post_init__(self):
        if self.num_ot <= 0:
            raise OTConfigError("need a non-zero number of OTs")
        if self.num_messages < 2:
            raise OTConfigError(
                f"an OT needs at least 2 messages, got {self.num_messages}")

    @classmethod
    def new_2_message(cls, num_ot: int) -> "OTConfig":
        return cls(num_ot=num_ot, num_messages=2)

    @classmethod
    def new_for_alsz_ote(cls, symmetric_security_parameter: int
                         ) -> "OTConfig":
        """Base-OT config for ALSZ/KOS OT extension: kappa 1-of-2 OTs."""
        return cls(num_ot=symmetric_security_parameter, num_messages=2)

    def verify_receiver_choices(self, choices) -> None:
        if len(choices) != self.num_ot:
            raise OTConfigError(
                f"expected {self.num_ot} choices, got {len(choices)}")
        if not all(0 <= c < self.num_messages for c in choices):
            raise OTConfigError("choice out of range")
