"""Card-only checks of the port (marker ``cuda``; skipped without a card,
where there is no nvcc either).

* The kernelcheck shared-memory mirror (`repro_torch.analysis.kernelcheck`
  ``smem_paged``/``smem_contiguous``) against the CUDA sources' own exports
  (``acam_attention_{paged,contiguous,single}_smem``) on every layout the
  plan checks meet over a serving domain cut to 128 keys, each within the
  card's opt-in shared memory a block. `chip_smoke.py` phase 24 (c) runs
  the full domain.
"""
import pytest

torch = pytest.importorskip("torch")

pytestmark = [
    pytest.mark.cuda,
    pytest.mark.skipif(not torch.cuda.is_available(),
                       reason="needs an NVIDIA card and nvcc to build the "
                              "kernels; the chip check runs it"),
]


def test_smem_mirror_equals_the_sources_exports():
    import ctypes

    from repro_torch.analysis import kernelcheck as KC
    from repro_torch.kernels import build
    from repro_torch.kernels.build import bind

    build.build_all(["acam_attention", "acam_attention_single"])
    I = ctypes.c_int
    exports = {"acam_attention_paged_smem": bind(
                   "acam_attention", "acam_attention_paged_smem", [I] * 10),
               "acam_attention_contiguous_smem": bind(
                   "acam_attention", "acam_attention_contiguous_smem",
                   [I] * 10),
               "acam_attention_single_smem": bind(
                   "acam_attention_single", "acam_attention_single_smem",
                   [I] * 8)}
    optin = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    findings, _, tally = KC.check_serving_plans(128)
    assert findings == []
    probes = KC.smem_probes(tally)
    assert len(probes) > 1000
    for name, args, nbytes in probes:
        got = exports[name](*args)
        assert got == nbytes, (name, args)
        assert got <= optin, (name, args)
