"""Shape-bucketed serving (counterpart of ``ssqueeze_rs_tpu/serve.py``).

`TransformServer` reflect-pads each request up to a fixed bucket length
and trims the output, so a server runs one input shape per (bucket,
channels): the transforms' host planning (scales, frequency grids,
filterbanks, windows) and the kernels' launch shapes repeat from request
to request. A request of length N returns the transform of the
bucket-padded signal trimmed back to N columns: the bucket fixes the
analysis configuration (scale grid, ssq frequency rows).

    server = TransformServer("ssq_cwt", fs=1000.0)
    out = server(x)          # dict: Tx, Wx, ssq_freqs, scales

Requests run on the server's device (`device`: the CUDA device by
default, `utils.common.array_device`); outputs come back as numpy arrays.

A request runs in the span `ssq.serve.request`, the transform in
`ssq.serve.run` and the trim and copy to host memory in `ssq.serve.fetch`
(`trace`). `trace.COUNTS` adds the samples requested to `serve.samples`
and the samples transformed, after the pad to the bucket, to
`serve.bucket_samples`: their ratio is the buckets' pad waste.
"""
from __future__ import annotations

import numpy as np
import torch

from .trace import count, span, spanned
from .utils.common import array_device, assert_is_one_of

__all__ = ["TransformServer", "DEFAULT_BUCKETS"]

DEFAULT_BUCKETS = (4096, 16384, 65536, 262144)


class TransformServer:
    """Bucketed dispatcher for the four transforms.

    `transform`: 'stft' | 'cwt' | 'ssq_cwt' | 'ssq_stft';
    `buckets`: ascending request-length capacities; `**kw` is passed to
    the underlying transform (fs, wavelet, n_fft, ...).
    """

    def __init__(self, transform="ssq_cwt", buckets=DEFAULT_BUCKETS,
                 dtype="float32", device=None, **kw):
        assert_is_one_of(transform, "transform",
                         ("stft", "cwt", "ssq_cwt", "ssq_stft"))
        self.transform = transform
        self.buckets = tuple(sorted(int(b) for b in buckets))
        self.dtype = dtype
        self.kw = dict(kw)
        if self.kw.get("rpadded"):
            # rpadded outputs keep the internal pad columns, which the
            # trim to the request length would silently keep
            raise ValueError("rpadded=True is unsupported in "
                             "TransformServer (outputs are trimmed to "
                             "request length); call the transform "
                             "directly for raw padded output")
        self.device = array_device(device)
        self._shapes = set()    # input shapes run so far
        self._meta = {}         # padded length -> host planning metadata

    def bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(f"request length {n} exceeds the largest bucket "
                         f"({self.buckets[-1]}); add a bigger bucket or "
                         "use parallel.process_recording")

    @property
    def n_compiled(self) -> int:
        """Distinct input shapes (channels, bucket) the server has run:
        the counterpart of the JAX server's compiled programs."""
        return len(self._shapes)

    @spanned("ssq.serve.run")
    def _run(self, xp):
        """The transform of the padded (C, b) requests: a dict of tensors
        on the device; the host planning outputs go to `_meta[b]`."""
        from .ops.cwt import cwt
        from .ops.ssq_cwt import ssq_cwt
        from .ops.ssq_stft import ssq_stft
        from .ops.stft import stft

        x = torch.as_tensor(np.ascontiguousarray(xp, self.dtype),
                            device=self.device)
        self._shapes.add(tuple(x.shape))
        b = x.shape[-1]
        kw, dtype = self.kw, self.dtype
        rest = {k: v for k, v in kw.items() if k != "wavelet"}
        if self.transform == "stft":
            return {"Sx": stft(x, dtype=dtype, **kw)}
        if self.transform == "cwt":
            Wx, sc = cwt(x, kw.get("wavelet", "gmw"), **rest, dtype=dtype)
            self._meta[b] = {"scales": np.asarray(sc)}
            return {"Wx": Wx}
        if self.transform == "ssq_cwt":
            Tx, Wx, fr, sc = ssq_cwt(x, kw.get("wavelet", "gmw"), **rest,
                                     dtype=dtype)
            self._meta[b] = {"ssq_freqs": np.asarray(fr),
                             "scales": np.asarray(sc)}
            return {"Tx": Tx, "Wx": Wx}
        Tx, Sx, fr, Sfs = ssq_stft(x, dtype=dtype, **kw)
        self._meta[b] = {"ssq_freqs": np.asarray(fr), "Sfs": np.asarray(Sfs)}
        return {"Tx": Tx, "Sx": Sx}

    def warmup(self, channels=(1,)):
        """Run every (bucket, channels) shape once at start-up, so no
        request pays the first call's planning and kernel build."""
        for c in channels:
            for b in self.buckets:
                self._run(np.zeros((int(c), b)))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self

    @spanned("ssq.serve.request")
    def __call__(self, x):
        """x: (N,) or (channels, N) array. Returns a dict of numpy arrays:
        the outputs trimmed to N columns, and the bucket's metadata."""
        x = np.asarray(x)
        squeeze = (x.ndim == 1)
        x = np.atleast_2d(x)
        N = x.shape[-1]
        b = self.bucket_for(N)
        pad = b - N
        xp = np.pad(x, ((0, 0), (0, pad)), mode="reflect") if pad else x
        count("serve.samples", x.size)
        count("serve.bucket_samples", xp.size)
        res = {}
        out = self._run(xp)
        with span("ssq.serve.fetch"):
            for k, v in out.items():
                a = v[..., :self._out_cols(N, b, v)].cpu().numpy()
                res[k] = a[0] if squeeze else a
        res.update(self._meta.get(b, {}))
        return res

    @spanned("ssq.serve.request")
    def batch(self, xs):
        """Serve many 1-D requests in one call: each is reflect-padded to
        the bucket of the longest, they are stacked on the channel axis,
        transformed once, and split back, each trimmed to its own length.
        The request count is rounded up to a power of 2 (copies of the
        last request, outputs dropped) so the shapes a server runs stay
        few. Returns a list of per-request dicts."""
        xs = [np.asarray(x) for x in xs]
        if not xs:
            return []
        if any(x.ndim != 1 for x in xs):
            raise ValueError("batch() takes 1D requests; use __call__ "
                             "for multichannel arrays")
        longest = max(len(x) for x in xs)
        b = self.bucket_for(longest)
        n = len(xs)
        nb = 1 << (n - 1).bit_length()
        padded = [np.pad(x, (0, b - len(x)), mode="reflect")
                  if len(x) < b else x for x in xs]
        padded += [padded[-1]] * (nb - n)
        count("serve.samples", sum(x.size for x in xs))
        count("serve.bucket_samples", nb * b)
        results = [dict() for _ in xs]
        out = self._run(np.stack(padded))
        with span("ssq.serve.fetch"):
            for k, v in out.items():
                # fetch only the requests and columns that are kept
                a = v[:n, ..., :self._out_cols(longest, b, v)].cpu().numpy()
                for i, x in enumerate(xs):
                    results[i][k] = a[i, ..., :self._out_cols(len(x), b, v)]
        for r in results:
            r.update(self._meta.get(b, {}))
        return results

    def _out_cols(self, N, bucket, v):
        n_out = v.shape[-1]
        if n_out == bucket:          # hop 1 / cwt: one column per sample
            return N
        # hop > 1: one column per hop starting at sample 0, so a direct
        # transform of length N has (N - 1)//hop + 1 columns
        hop = int(self.kw.get("hop_len", 1))
        return min(n_out, (N - 1) // hop + 1)
