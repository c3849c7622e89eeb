"""The reference against the port's CPU path at small sizes: its frozen
planning equal to the program's, its transforms within the comparison's
limits of the program's outputs, its padding numpy's, its column blocks
the whole transform's."""
import numpy as np
import pytest
import torch

import ssqueeze_rs_tpu_torch as S
from ssqueeze_rs_tpu_torch.scales import process_scales
from core import bench, check
from reference import transforms

B = bench.Bench()


def cfg_of(name):
    return B.json("configs", name)


def signal(n, seed=0, batch=2):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(batch, n, generator=g, dtype=torch.float64)
            + 2 * torch.sin(0.3 * torch.arange(n))).float()


@pytest.mark.parametrize("n", [4096, 10000, 160000])
def test_cwt_planning_is_the_programs(n):
    cfg = cfg_of("ssq_cwt_gmw_300")
    plan = transforms.CwtPlan(cfg, n)
    sc = process_scales("log-piecewise", n, S.Wavelet.build("gmw"))[:300]
    assert np.array_equal(sc.squeeze(), plan.scales)
    from ssqueeze_rs_tpu_torch.ops.ssqueeze import plan_ssqueeze
    fr, const, _, _ = plan_ssqueeze(n, len(sc), None, sc, fs=1.0,
                                    maprange="peak",
                                    wavelet=S.Wavelet.build("gmw"))
    assert np.array_equal(fr, plan.freqs)
    assert np.array_equal(const, plan.const)


@pytest.mark.parametrize("transform,cfg_name", [
    ("ssq_cwt", "ssq_cwt_gmw_300"), ("ssq_stft", "ssq_stft_598")])
def test_reference_holds_the_cpu_port_within_limits(transform, cfg_name):
    cfg = cfg_of(cfg_name)
    system = B.module("systems", transform)
    n = 8192
    x = signal(n)
    out = system.call(x, system.prepare(cfg, n, torch.device("cpu")))
    chk = check.Check(system, cfg, torch.device("cpu"))
    items = [dict(n=n, x=x[c], cols=slice(0, n),
                  out={k: (v[c] if isinstance(v, torch.Tensor) else v)
                       for k, v in out.items()}) for c in range(2)]
    nums = chk.numbers(items)
    correct, table = check.verdict(nums, cfg["limits"])
    assert correct, table


def test_reflect_pad_is_numpys():
    x = np.random.default_rng(1).standard_normal(1000)
    for n1, n2 in [(0, 999), (0, 5000), (300, 298), (0, 31000)]:
        got = transforms.reflect_pad(torch.as_tensor(x), n1, n2).numpy()
        assert np.array_equal(got, np.pad(x, (n1, n2), mode="reflect"))


@pytest.mark.parametrize("transform,cfg_name", [
    ("ssq_cwt", "ssq_cwt_gmw_300"), ("ssq_stft", "ssq_stft_598")])
def test_column_blocks_equal_the_whole(transform, cfg_name):
    ref = B.module("systems", transform).Reference(cfg_of(cfg_name), 4096)
    x = signal(4096, batch=1)[0]
    whole = ref(x)
    part = ref(x, cols=slice(1000, 1700))
    for k in whole:
        assert torch.equal(part[k], whole[k][:, 1000:1700])
