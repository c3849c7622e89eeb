from .common import WARN, NOTE, assert_is_one_of
from .fft import xifn
from .pad import p2up, pad_params, padsignal

__all__ = ["WARN", "NOTE", "assert_is_one_of", "xifn", "p2up", "pad_params",
           "padsignal"]
