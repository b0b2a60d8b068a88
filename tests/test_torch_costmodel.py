"""The port's analog cost model (`repro_torch.hw`: params, simulator,
area, gce) against the reference's `repro.hw`.

* `simulate()` for every catalog model the port builds, under the three
  architectures, field for field ``==`` to the reference's float64 result,
  the workload made from the port's own ModelConfig; `gpu_reference` too.
* `table_iv()`, `gce_unit_arrays()`, `k_sweep` and `optimal_k_range`
  equal, from the port's compiler and ACAM functions.
* Mirrors tests/test_substrate.py's paper ordering and k-sweep plateau,
  tests/test_core_acam.py's GCE budget and tests/test_exec_noise.py's
  degenerate-workload guards.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

import _torch_helpers  # noqa: E402,F401  (one torch thread a worker)

from repro.configs import get_config as r_get_config  # noqa: E402
from repro.hw import area as RA  # noqa: E402
from repro.hw import gce as RG  # noqa: E402
from repro.hw import params as RP  # noqa: E402
from repro.hw import simulator as RS  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs.catalog import PORTED  # noqa: E402
from repro_torch.hw import area as TA  # noqa: E402
from repro_torch.hw import gce as TG  # noqa: E402
from repro_torch.hw import params as TP  # noqa: E402
from repro_torch.hw import simulator as TS  # noqa: E402

ARCHS = ("raceit", "puma", "retransformer")


def test_every_catalog_model_is_covered():
    from repro.configs.catalog import ASSIGNED, PAPER_OWN
    assert sorted(PORTED) == sorted(set(ASSIGNED) | set(PAPER_OWN))
    assert len(PORTED) == 13


def test_params_are_the_references():
    for name in ("CoreParams", "ChipParams"):
        assert dataclasses.asdict(getattr(TP, name)()) == \
            dataclasses.asdict(getattr(RP, name)())
    core, rcore = TP.CoreParams(), RP.CoreParams()
    for prop in ("acam_array_power_mw", "acam_array_area_um2",
                 "n_gce_arrays", "xbar_mvm_ns"):
        assert getattr(core, prop) == getattr(rcore, prop)
    assert TP.ChipParams().n_xbars == RP.ChipParams().n_xbars
    for name in ("GCE_DEFAULT", "CMOS_OPERATORS", "PAPER_CLAIMS",
                 "PUMA_VFU_MULTS_PER_CORE", "RERAM_WRITE_NS_PER_ROW",
                 "MW", "UM2"):
        assert getattr(TP, name) == getattr(RP, name), name
    assert TS.PARALLELISM == RS.PARALLELISM
    assert TS.ENERGY_PER_OP == RS.ENERGY_PER_OP


@pytest.mark.parametrize("seq_len", [128, 384])
@pytest.mark.parametrize("name", PORTED)
def test_simulate_field_for_field(name, seq_len):
    tw = TS.Workload.from_config(t_get_config(name), seq_len)
    rw = RS.Workload.from_config(r_get_config(name), seq_len)
    assert dataclasses.asdict(tw) == dataclasses.asdict(rw)
    assert tw.macs_per_token == rw.macs_per_token
    assert TS._chips_needed(tw) == RS._chips_needed(rw)
    assert TS.raceit_stage_times(tw) == RS.raceit_stage_times(rw)
    for arch in ARCHS:
        got, want = TS.simulate(tw, arch), RS.simulate(rw, arch)
        assert got == want, (name, arch)
        assert TS._row_ns(tw, arch) == RS._row_ns(rw, arch)
        if arch == "raceit":
            assert TS.gpu_reference(got) == RS.gpu_reference(want)


def test_table_iv_and_gce_unit_arrays():
    assert TA.table_iv() == RA.table_iv()
    assert TA.gce_unit_arrays() == RA.gce_unit_arrays()
    for name in ("adc4", "mult4", "gelu8", "softmax8"):
        for enc in (False, True):
            assert TA.operator_cost(name, enc) == RA.operator_cost(name, enc)
    with pytest.raises(KeyError):
        TA.operator_cost("bogus", True)


def test_array_sizing_budget():
    """tests/test_core_acam.py:125: 454 4-bit multipliers + 16 exp units
    fit the 1280-array GCE (§VI)."""
    u = TA.gce_unit_arrays()
    total = (454 * u["mult4_arrays_frac"] + 16 * u["exp8"] + u["log8"]
             + u["act8"])
    assert total <= 1280 * 1.02


@pytest.mark.parametrize("name", ["bert-base", "bert-large", "gpt2-large"])
def test_k_sweep_and_optimal_k_range(name):
    for seq_len, ks in ((384, None), (256, [1.0, 8.0, 28.3, 100.0])):
        got = TG.k_sweep(t_get_config(name), seq_len=seq_len, ks=ks)
        want = RG.k_sweep(r_get_config(name), seq_len=seq_len, ks=ks)
        assert got == want
        for tol in (0.05, 0.15):
            assert TG.optimal_k_range(got, tol) == RG.optimal_k_range(want,
                                                                      tol)
    for k in (0.5, 28.3, 300.0):
        assert TG.split_for_k(k) == RG.split_for_k(k)


def test_simulator_reproduces_paper_ordering():
    """tests/test_substrate.py:152, on the port."""
    w = TS.Workload.from_config(t_get_config("bert-base"))
    r = {a: TS.simulate(w, a) for a in ARCHS}
    assert (r["raceit"]["tokens_per_s"] > r["retransformer"]["tokens_per_s"]
            > r["puma"]["tokens_per_s"])
    sp = r["raceit"]["tokens_per_s"] / r["puma"]["tokens_per_s"]
    assert 4.5 < sp < 7.5  # paper: 5.9x
    en = (r["puma"]["energy_per_token_uj"]
          / r["raceit"]["energy_per_token_uj"])
    assert 3.0 < en < 5.0  # paper: 3.9x
    assert abs(r["raceit"]["tops"] - 110.11) / 110.11 < 0.05  # Table V


def test_k_sweep_plateau_contains_paper_choice():
    """tests/test_substrate.py:165, on the port."""
    rows = TG.k_sweep(t_get_config("bert-base"), seq_len=384)
    lo, hi = TG.optimal_k_range(rows, 0.15)
    assert lo <= 28.3 <= hi
    assert len(rows) == 25 and np.isclose(rows[0]["k"], 0.5)


def test_simulator_rejects_degenerate_workloads():
    """tests/test_exec_noise.py:236, on the port."""
    W = TS.Workload
    res = TS.simulate(W("w", n_layers=2, d_model=64, d_ff=128, seq_len=16))
    assert res["tops_per_w"] > 0
    with pytest.raises(ValueError, match="n_layers"):
        TS.simulate(W("w", 0, 64, 128, 16))
    with pytest.raises(ValueError, match="seq_len"):
        TS.simulate(W("w", 2, 64, 128, 0))
    with pytest.raises(ValueError, match="d_ff"):
        TS.simulate(W("w", 2, 64, None, 16))
    with pytest.raises(ValueError, match="d_model"):
        TS.simulate(W("w", 2, 0, 128, 16))
    with pytest.raises(ValueError, match="tokens_per_s"):
        TS.gpu_reference({})
    with pytest.raises(ValueError, match="tokens_per_s"):
        TS.gpu_reference({"tokens_per_s": 0.0, "energy_per_token_uj": 1.0})
    with pytest.raises(ValueError, match="energy_per_token_uj"):
        TS.gpu_reference({"tokens_per_s": 10.0})
    assert TS.gpu_reference(res)["p100_tokens_per_s"] > 0
    with pytest.raises(KeyError):
        TS.simulate(W("w", 2, 64, 128, 16), "tpu")


def test_hw_package_surface():
    import repro.hw as R
    import repro_torch.hw as T
    for mod in ("area", "gce", "noise", "params", "simulator"):
        assert hasattr(T, mod) and hasattr(R, mod)
    assert T.NoiseConfig is T.noise.NoiseConfig
