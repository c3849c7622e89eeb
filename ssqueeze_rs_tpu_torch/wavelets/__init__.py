from .base import Wavelet
from . import families  # noqa: F401  (registers morlet/bump/cmhat/hhhat)
from . import gmw as _gmw_mod  # noqa: F401  (registers gmw)
from .gmw import morsefreq, morseafun, gmw_k_constants
from .props import (center_frequency, find_maximum, find_first_occurrence,
                    time_resolution)
from .adm import adm_ssq, adm_cwt, integrate_analytic

__all__ = [
    "Wavelet", "morsefreq", "morseafun", "gmw_k_constants", "center_frequency",
    "find_maximum", "find_first_occurrence", "time_resolution", "adm_ssq",
    "adm_cwt",
    "integrate_analytic",
]
