"""The system under test for configurations with "transform": "ssq_stft":
`ssqueeze_rs_tpu_torch.ssq_stft` on a batch, `TransformServer('ssq_stft')`
for served requests, and the reference's plain ssq_stft beside them."""
from __future__ import annotations

from core import check
from reference import transforms


def _kw(cfg):
    return dict(n_fft=cfg["n_fft"], hop_len=cfg["hop_len"], fs=cfg["fs"],
                padtype=cfg["padtype"], dtype=cfg["dtype"])


def prepare(cfg, n, device):
    return dict(kw=_kw(cfg))


def call(x, prep):
    """One batch call (the default window: None). Outputs stay on the
    device."""
    from ssqueeze_rs_tpu_torch import ssq_stft
    Tx, Sx, freqs, sfs = ssq_stft(x, **prep["kw"])
    return {"Tx": Tx, "Sx": Sx, "freqs": freqs, "Sfs": sfs}


def server(cfg, buckets, device):
    from ssqueeze_rs_tpu_torch import TransformServer
    return TransformServer("ssq_stft", buckets=buckets, device=device,
                           **_kw(cfg))


def served(res):
    return {"Tx": res["Tx"], "Sx": res["Sx"], "freqs": res["ssq_freqs"],
            "Sfs": res["Sfs"]}


def compare(out, exp, ref, device):
    """`plan_rel`, the ssq frequencies and Sfs (max |d| / max |ref|);
    `planes_rel`, Sx (the same); `tx_l1`, Tx (sum |d| / sum |ref|)."""
    return {"plan_rel": check.host_rel(out, ref.host()),
            "planes_rel": check.rel_max(out["Sx"], exp["Sx"], device),
            "tx_l1": check.rel_l1(out["Tx"], exp["Tx"], device)}


class Reference:
    """The plain ssq_stft of the configuration at n samples."""

    def __init__(self, cfg, n, served=False):
        self.plan = transforms.StftPlan(cfg, n)

    def __call__(self, x, precision="float64", cols=None):
        tx, sx = transforms.ssq_stft(x, self.plan, precision, cols)
        return {"Tx": tx, "Sx": sx}

    def host(self):
        """Planning outputs: the ssq frequencies and the rows' Sfs, both
        the linear grid 0 .. fs / 2, ascending."""
        return {"freqs": self.plan.freqs, "Sfs": self.plan.freqs}

    def shapes(self):
        return dict(nf=self.plan.nf, n_fft=self.plan.n_fft)
