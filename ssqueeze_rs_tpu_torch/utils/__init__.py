from .common import WARN, NOTE, assert_is_one_of, mad, mad_rms
from .fft import xifn
from .pad import p2up, pad_params, padsignal
from .windows import get_window, window_norm, check_nola

__all__ = ["WARN", "NOTE", "assert_is_one_of", "mad", "mad_rms", "xifn",
           "p2up", "pad_params", "padsignal", "get_window", "window_norm",
           "check_nola"]
