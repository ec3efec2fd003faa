"""Secure-computation core of the port (ring, PRF, RSS, protocols)."""
from .comm import CommLedger, track
from .prf import PRNGKey
from .randomness import Parties
from .ring import RING32, RingSpec
from .rss import RSS, BinRSS, reconstruct, share
from .secure_model import compile_secure, secure_infer, secure_infer_cost

__all__ = ["CommLedger", "track", "PRNGKey", "Parties", "RING32", "RingSpec",
           "RSS", "BinRSS", "reconstruct", "share", "compile_secure",
           "secure_infer", "secure_infer_cost"]
