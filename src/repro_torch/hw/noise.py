"""Device-variation noise models for the RACE-IT analog substrate.

The port of `repro.hw.noise`: the fidelity layer behind the
``raceit_noisy_*`` backends (`repro_torch.exec.noisy`). A frozen
`NoiseConfig` carried on ``ExecConfig.noise`` names how far the simulated
devices deviate from the compiled programs, per physical mechanism:

  acam_sigma          ACAM threshold-voltage variation, in input-code LSBs
                      (`repro_torch.core.acam.jitter_codes`,
                      ``AcamFunction.apply_codes_noisy``; the per-cell form
                      is ``RangeArrays.jittered``).
  conductance_sigma   Crossbar cell-conductance variation for the MVM path,
                      as a fraction of the full conductance range, applied
                      to stored weight codes in the ISAAC unsigned offset
                      domain (`perturb_weight_codes`).
  stuck_rate          Fraction of crossbar cells stuck at G_min/G_max
                      (half each), same unsigned domain.
  readout_sigma       ACAM output/readout noise, in output-code LSBs.
  fault_rate          Per-row catastrophic-fault probability on the noisy
                      attention backends (rows go non-finite). Zero in all
                      presets; it drives the fail-safe serving path.

Determinism: each injection site derives its key as ``site_key(noise, tag,
shape)``, a pure function of (``NoiseConfig.seed``, a site tag, the
operand shape), and the draws are JAX's, bit for bit
(`repro_torch.hw.prng`), so a seed and config give the reference's codes.
The reference's draws constant-fold into its jitted executables, a static
fault map per device. Here they are made once on the host, at their first
use, and kept with their device copies in a cache keyed by (draw kind, key,
shape, scale): exact, because the key is pure in (seed, tag, shape), and
never keyed on a weight tensor. Every helper is a no-op when its knobs are
zero, so a zero-sigma ``NoiseConfig`` is bit-identical to the clean
backends.
"""
from __future__ import annotations

import dataclasses
import functools
import time
import zlib
from typing import Optional

import numpy as np
import torch

from ..core.acam import jitter_codes  # noqa: F401  (re-export: the
#   input-referred ACAM jitter primitive lives with the ACAM semantics)
from . import prng

__all__ = ["NoiseConfig", "site_key", "jitter_codes", "perturb_weight_codes",
           "fault_rows", "normal_offsets", "PRESETS", "draw_cache_info",
           "clear_draw_cache"]

# the "nominal" device-variation profile; worst_case = 4x nominal. The
# magnitudes are plausible for ReRAM ACAM/crossbar arrays (sub-LSB
# threshold jitter, ~1% conductance spread, ~0.1% stuck cells) — they are
# sweep anchors for Fig.-14-style accuracy-vs-noise curves, not measured
# silicon data.
_NOMINAL = dict(acam_sigma=0.5, conductance_sigma=0.01,
                stuck_rate=0.001, readout_sigma=0.5)
PRESETS = {
    "clean": {k: 0.0 for k in _NOMINAL},
    "nominal": dict(_NOMINAL),
    "worst_case": {k: 4.0 * v for k, v in _NOMINAL.items()},
}


@dataclasses.dataclass(frozen=True)
class NoiseConfig:
    """Frozen (hashable) device-noise knobs; rides on ``ExecConfig.noise``.

    Being frozen matters: `repro_torch.exec.plan.resolve_plan` is
    lru-cached over the full ExecConfig, so two configs differing only in
    noise resolve to distinct plans.
    """

    acam_sigma: float = 0.0         # input-code LSBs
    conductance_sigma: float = 0.0  # fraction of the full code range
    stuck_rate: float = 0.0         # fraction of cells (half off, half on)
    readout_sigma: float = 0.0      # output-code LSBs
    fault_rate: float = 0.0         # per-row catastrophic decode faults
    seed: int = 0

    @property
    def is_clean(self) -> bool:
        return (self.acam_sigma <= 0.0 and self.conductance_sigma <= 0.0
                and self.stuck_rate <= 0.0 and self.readout_sigma <= 0.0
                and self.fault_rate <= 0.0)

    @classmethod
    def preset(cls, name: str, seed: int = 0) -> "NoiseConfig":
        return cls(seed=seed, **PRESETS[name])

    @classmethod
    def scaled(cls, lam: float, seed: int = 0) -> "NoiseConfig":
        """``lam`` x the nominal profile (0 = clean, 1 = nominal, 4 =
        worst_case)."""
        return cls(seed=seed, **{k: lam * v for k, v in _NOMINAL.items()})

    @classmethod
    def parse(cls, spec, seed: int = 0) -> "NoiseConfig":
        """``--noise`` surface: a preset name or a float sigma scale."""
        if isinstance(spec, (int, float)) and not isinstance(spec, bool):
            return cls.scaled(float(spec), seed=seed)
        s = str(spec).strip().lower()
        if s in PRESETS:
            return cls.preset(s, seed=seed)
        try:
            lam = float(s)
        except ValueError:
            raise ValueError(
                f"unknown noise spec {spec!r}: expected a preset "
                f"({sorted(PRESETS)}) or a float scale of the nominal "
                f"profile") from None
        return cls.scaled(lam, seed=seed)


def site_key(noise: NoiseConfig, tag: str, shape: tuple = ()) -> np.ndarray:
    """Deterministic per-injection-site key (a read-only (2,) uint32 array,
    JAX's key data): the seed's key, folded with the tag's CRC-32 and then
    with each dim of the operand shape in order. Memoized: a serving step
    asks for the same few keys in every layer."""
    return _site_key(int(noise.seed), tag, tuple(int(d) for d in shape))


@functools.lru_cache(maxsize=4096)
def _site_key(seed: int, tag: str, shape: tuple) -> np.ndarray:
    key = prng.PRNGKey(seed)
    key = prng.fold_in(key, zlib.crc32(tag.encode()) & 0x7FFFFFFF)
    for dim in shape:
        key = prng.fold_in(key, dim)
    key.flags.writeable = False
    return key


# ---------------------------------------------------------------------------
# the draw cache
# ---------------------------------------------------------------------------

_DRAWS: dict = {}  # (kind, key, shape, scale[, device]) -> tensor
_STATS = {"draws": 0, "seconds": 0.0}


def _cached(kind: str, key: np.ndarray, shape, scale, device, make):
    """The tensor ``make()`` draws for (kind, key, shape, scale) on
    ``device``: drawn on the host once, copied to each device once."""
    host_key = (kind, key.tobytes(), tuple(int(d) for d in shape), scale)
    device = torch.device(device)
    dev_key = host_key + (str(device),)
    t = _DRAWS.get(dev_key)
    if t is None:
        host = _DRAWS.get(host_key)
        if host is None:
            t0 = time.perf_counter()
            host = torch.from_numpy(np.ascontiguousarray(make()))
            _STATS["seconds"] += time.perf_counter() - t0
            _STATS["draws"] += 1
            _DRAWS[host_key] = host
        t = host if device.type == "cpu" else host.to(device)
        _DRAWS[dev_key] = t
    return t


def draw_cache_info() -> dict:
    """Draws made, host seconds spent drawing, and the bytes the cache
    holds on the host and on other devices."""
    host = dev = 0
    for k, t in _DRAWS.items():
        n = t.numel() * t.element_size()
        if len(k) == 4:
            host += n
        elif not k[-1].startswith("cpu"):
            dev += n
    return dict(draws=_STATS["draws"], seconds=_STATS["seconds"],
                host_bytes=host, device_bytes=dev, entries=len(_DRAWS))


def clear_draw_cache() -> None:
    _DRAWS.clear()
    _STATS.update(draws=0, seconds=0.0)


def normal_offsets(key: np.ndarray, shape, scale: float,
                   device) -> torch.Tensor:
    """int32 ``round(scale * normal(key, shape))`` on ``device``: the
    reference multiplies the float32 draw by the weakly typed Python
    ``scale`` (cast to float32), then rounds half to even."""
    def make():
        z = prng.normal(key, tuple(shape))
        return np.round(np.float32(scale) * z).astype(np.int32)
    return _cached("normal", key, shape, float(scale), device, make)


def _stuck_masks(key: np.ndarray, shape, rate: float, device):
    """(stuck-off, stuck-on) bool masks: a uniform draw below ``rate / 2``
    pins the cell to G_min, one in [rate / 2, rate) to G_max (thresholds
    cast to float32, as JAX's weak typing does)."""
    def make():
        r = prng.uniform(key, tuple(shape))
        half, full = np.float32(rate / 2), np.float32(rate)
        return np.stack([r < half, (r >= half) & (r < full)])
    both = _cached("stuck", key, shape, float(rate), device, make)
    return both[0], both[1]


# ---------------------------------------------------------------------------
# injection helpers
# ---------------------------------------------------------------------------

def perturb_weight_codes(codes: torch.Tensor, noise: NoiseConfig,
                         key: np.ndarray, bits: int = 8) -> torch.Tensor:
    """Crossbar conductance variation + stuck-at cells on stored weights.

    Works in the ISAAC unsigned offset domain the crossbar programs (``code
    + 2^(bits-1)``): a Gaussian conductance spread of ``conductance_sigma *
    full_range`` codes, clipped to the range, then ``stuck_rate`` of the
    cells pinned to G_min or G_max, half each. Returns the perturbed signed
    codes; a no-op when both knobs are zero.
    """
    if noise.conductance_sigma <= 0.0 and noise.stuck_rate <= 0.0:
        return codes
    off = 1 << (bits - 1)
    top = (1 << bits) - 1
    u = codes.to(torch.int32) + off  # unsigned conductance domain
    kg, ks = prng.split(key)
    shape = tuple(u.shape)
    if noise.conductance_sigma > 0.0:
        g = normal_offsets(kg, shape, noise.conductance_sigma * top,
                           u.device)
        u = torch.clamp(u + g, 0, top)
    if noise.stuck_rate > 0.0:
        stuck_off, stuck_on = _stuck_masks(ks, shape, noise.stuck_rate,
                                           u.device)
        u = u.masked_fill(stuck_off, 0).masked_fill(stuck_on, top)
    return (u - off).to(codes.dtype)


def fault_rows(noise: NoiseConfig, key: np.ndarray, n_rows: int,
               device="cpu") -> Optional[torch.Tensor]:
    """(n_rows,) bool mask of catastrophically faulted batch rows on
    ``device``: Bernoulli(``fault_rate``) per row from a uniform draw; None
    when the rate is zero."""
    if noise.fault_rate <= 0.0:
        return None
    rate = np.float32(noise.fault_rate)
    return _cached("fault", key, (n_rows,), float(noise.fault_rate), device,
                   lambda: prng.uniform(key, (n_rows,)) < rate)
