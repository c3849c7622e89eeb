"""The system under test for configurations with "transform": "ssq_cwt":
`ssqueeze_rs_tpu_torch.ssq_cwt` on a batch, `TransformServer('ssq_cwt')`
for served requests, and the reference's plain ssq_cwt beside them."""
from __future__ import annotations

from core import check
from reference import transforms


def _kw(cfg):
    wv = dict(cfg["wavelet"])
    return dict(wavelet=(wv.pop("name"), wv), fs=cfg["fs"],
                maprange=cfg["maprange"], padtype=cfg["padtype"],
                dtype=cfg["dtype"])


def prepare(cfg, n, device):
    """Set-up of the batch path: the scale grid of an n-sample signal,
    planned once by the program, as the upstream benchmark's caller does."""
    from ssqueeze_rs_tpu_torch import Wavelet
    from ssqueeze_rs_tpu_torch.scales import process_scales
    kw = _kw(cfg)
    scales = process_scales(cfg["scales"], n, Wavelet.build(kw["wavelet"]),
                            nv=cfg["nv"])
    if cfg.get("rows"):
        scales = scales[:int(cfg["rows"])]
    return dict(kw=kw, scales=scales)


def call(x, prep):
    """One batch call: x (B, n) float32 on the device. Outputs stay on the
    device."""
    from ssqueeze_rs_tpu_torch import ssq_cwt
    kw = dict(prep["kw"])
    Tx, Wx, freqs, scales = ssq_cwt(x, kw.pop("wavelet"),
                                    scales=prep["scales"], **kw)
    return {"Tx": Tx, "Wx": Wx, "freqs": freqs, "scales": scales}


def server(cfg, buckets, device):
    """The served path: the scales planned per bucket by the server from
    the configuration's scale type."""
    from ssqueeze_rs_tpu_torch import TransformServer
    return TransformServer("ssq_cwt", buckets=buckets, device=device,
                           scales=cfg["scales"], nv=cfg["nv"], **_kw(cfg))


def served(res):
    """A served request's outputs under the check's names."""
    return {"Tx": res["Tx"], "Wx": res["Wx"], "freqs": res["ssq_freqs"],
            "scales": res["scales"]}


def compare(out, exp, ref, device):
    """The numbers the configuration's limits hold: `plan_rel`, the ssq
    frequencies and scales (max |d| / max |ref|); `planes_rel`, Wx (the
    same); `tx_l1`, Tx (sum |d| / sum |ref|)."""
    return {"plan_rel": check.host_rel(out, ref.host()),
            "planes_rel": check.rel_max(out["Wx"], exp["Wx"], device),
            "tx_l1": check.rel_l1(out["Tx"], exp["Tx"], device)}


class Reference:
    """The plain ssq_cwt of the configuration at n samples. The row cap
    holds on the batch path only, where the caller passes the capped
    grid; the server plans the whole grid of its bucket."""

    def __init__(self, cfg, n, served=False):
        cfg = dict(cfg)
        if served:
            cfg.pop("rows", None)
        self.plan = transforms.CwtPlan(cfg, n)

    def __call__(self, x, precision="float64", cols=None):
        tx, wx = transforms.ssq_cwt(x, self.plan, precision, cols)
        return {"Tx": tx, "Wx": wx}

    def host(self):
        """The planning outputs as the program returns them: frequencies
        high to low (Tx's row 0 is the highest), and the scales."""
        return {"freqs": self.plan.freqs[::-1], "scales": self.plan.scales}

    def shapes(self):
        p = self.plan
        return dict(na=len(p.scales), nf=p.nf, m=p.m)
