"""Error-locating generalized-RS decode — silent-bitrot recovery without
checksums: the port's own copy of the JAX package's ``gf_decode/``
(NumPy only), imports redirected to :mod:`..ops.gf`.

The erasure decoder (Vandermonde + Gauss-Jordan, the paper's path) can
only rebuild chunks it KNOWS are bad; a flipped byte in a chunk that
passes no CRC propagates silently into the reconstructed file.  This
subsystem adds the syndrome / Berlekamp–Welch machinery of arXiv
1702.07737 ("Decoding Generalized Reed-Solomon Codes"): a parity-check
view of the code (:mod:`.syndrome`; the syndrome GEMM itself runs on the
device through :meth:`..codec.RSCodec.syndrome`), a key-equation solver over GF(2^8)/GF(2^16) that
returns error LOCATIONS and magnitudes per column (:mod:`.bw`), and a
corrected-decode that patches located symbols in place before the normal
inverse-GEMM reconstruction (:mod:`.correct`).

Wired through :mod:`..api`: ``locate_decode_file`` (CLI ``-d --locate``),
the scrub syndrome pre-check (``--scrub --syndrome``,
``state="silent_bitrot"``), and the ``auto_decode_file`` escalation
ladder's final rung (exclude → rescan → reselect → locate).
"""

from .bw import (  # noqa: F401
    UnlocatableError,
    berlekamp_massey,
    gf_solve,
    locate_column,
    locate_segment,
)
from .correct import LocateContext, correct_segment  # noqa: F401
from .syndrome import (  # noqa: F401
    erasure_reduced_check,
    is_systematic,
    parity_check_matrix,
    vandermonde_points,
)
