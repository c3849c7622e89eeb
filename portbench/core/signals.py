"""The one generator of the benchmark's inputs: a traffic file's
"signal" parameters and the run's seed give each call or request its own
signal, white noise plus tones, the same for the same (seed, index) on any
run, so that the reference can make a checked call's input again. A batch
is made on the device (`make`), a served request on the host as its client
hands it over (`make_host`)."""
from __future__ import annotations

import numpy as np
import torch


def _seeds(seed, index):
    """A 63-bit torch seed and a numpy generator, both from (seed, index),
    for any whole numbers, also past 32 bits."""
    ss = np.random.SeedSequence([int(seed) % (1 << 64), int(index) + (1 << 20)])
    state = ss.generate_state(2, np.uint64)
    return int(state[0] >> np.uint64(1)), np.random.default_rng(state[1])


def _tones(params, rng, shape):
    """(3, ..., tones) amplitudes, frequencies and phases, or None."""
    tones = int(params.get("tones", 0))
    if not tones:
        return None
    lead = tuple(shape[:-1]) + (tones,)
    return np.stack([rng.uniform(*params["amp"], size=lead),
                     rng.uniform(*params["freq"], size=lead),
                     rng.uniform(0, 2 * np.pi, size=lead)])


def make(params, seed, index, shape, device):
    """float32 signal(s) of `shape` (..., n) on `device`: `noise` times
    unit white noise, plus `tones` sinusoids per channel, each with an
    amplitude, a frequency (cycles a sample) and a phase drawn uniformly
    from `amp`, `freq` and [0, 2 pi)."""
    tseed, rng = _seeds(seed, index)
    gen = torch.Generator(device=device).manual_seed(tseed)
    x = torch.randn(shape, generator=gen, device=device,
                    dtype=torch.float32) * float(params.get("noise", 1.0))
    coef = _tones(params, rng, shape)
    if coef is not None:
        coef = torch.as_tensor(coef, device=device, dtype=torch.float64)
        t = torch.arange(shape[-1], device=device, dtype=torch.float64)
        arg = 2 * np.pi * coef[1, ..., None] * t + coef[2, ..., None]
        x += (coef[0, ..., None] * torch.sin(arg)).sum(-2).to(torch.float32)
    return x


def make_host(params, seed, index, shape):
    """As `make`, as a float32 numpy array made on the host (numpy's
    generator for the noise)."""
    _, rng = _seeds(seed, index)
    x = rng.standard_normal(shape) * float(params.get("noise", 1.0))
    coef = _tones(params, rng, shape)
    if coef is not None:
        t = np.arange(shape[-1], dtype=np.float64)
        arg = 2 * np.pi * coef[1, ..., None] * t + coef[2, ..., None]
        x += (coef[0, ..., None] * np.sin(arg)).sum(-2)
    return x.astype(np.float32)
