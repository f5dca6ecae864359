"""Runtime configuration for the matching protocol.

Lifts the reference's compile-time constants (reference include/config.h)
into a real config object, as SURVEY.md section 5 prescribes.  The port's
own copy of image_matching_tpu/matching/config.py: every field, the same
defaults.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MatchConfig:
    vector_dim: int = 512        # reference VECTOR_DIM (include/config.h:30)
    chunk_len: int = 128         # Blind-Match CHUNK_LEN (include/config.h:34)
    match_threshold: float = 0.44  # MATCH_THRESHOLD (include/config.h:9)
    comp_depth: int = 10         # COMP_DEPTH (include/config.h:14)
    alpha_depth: int = 2         # ALPHA_DEPTH (include/config.h:18)
    use_bsgs: bool = True        # BSGS diagonal matmul (TPU-native extra)
    faithful_hers: bool = False  # per-term relin+rescale as in HERS paper
                                 # (reference src/sender/sender_hers.cpp:70-72)
    hers_alt_query: bool = False  # encryptQueryAlt: 1-ciphertext query,
                                  # expanded server-side via
                                  # generateQueryHelper (reference
                                  # receiver_hers.cpp:66-77,
                                  # sender_hers.cpp:101-115); costs one
                                  # extra level of depth
    faithful_grote: bool = False  # membership computes-and-discards the
                                  # alpha-norm colCipher exactly like the
                                  # reference (src/sender/sender_grote.cpp:23)
                                  # so benchmark comparisons against its
                                  # published numbers include the same work
