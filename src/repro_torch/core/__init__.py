"""Secure-computation core of the port (ring, PRF, RSS, protocols)."""
from .comm import CommLedger, track
from .preprocessing import (MaterialSpec, MaterialTape, TapeParties,
                            generate_tape, tape_session_keys, trace_material)
from .prf import PRNGKey
from .randomness import Parties
from .ring import RING32, RING64, RingSpec
from .rss import RSS, BinRSS, reconstruct, reconstruct_bits, share, share_bits
from .secure_model import compile_secure, secure_infer, secure_infer_cost

__all__ = ["CommLedger", "track", "PRNGKey", "Parties", "RING32", "RING64",
           "RingSpec", "RSS", "BinRSS", "reconstruct", "reconstruct_bits",
           "share", "share_bits", "compile_secure",
           "secure_infer", "secure_infer_cost", "MaterialSpec",
           "MaterialTape", "TapeParties", "trace_material", "generate_tape",
           "tape_session_keys"]
