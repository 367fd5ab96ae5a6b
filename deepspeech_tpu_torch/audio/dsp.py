"""Host-side DSP: polyphase resampling (numpy/scipy)."""

from __future__ import annotations

from fractions import Fraction

import numpy as np
import scipy.signal


def resample(y: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Polyphase resampling (band-limited, like librosa's soxr/resampy path)."""
    if sr_in == sr_out:
        return y.astype(np.float32, copy=False)
    frac = Fraction(sr_out, sr_in).limit_denominator(1000)
    out = scipy.signal.resample_poly(y.astype(np.float32), frac.numerator,
                                     frac.denominator)
    return out.astype(np.float32)
