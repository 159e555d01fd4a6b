"""Global configuration helpers (port of ``ocm_tpu/config.py``).

The reference computes every statistic in NumPy float64.  The JAX package
follows JAX's x64 switch: off on its accelerator (float32, the fast path),
on for its CPU parity runs (float64).  The port has no global switch; the
device decides, through ``stats_dtype(device)``:

- on CUDA, float32: the counterpart of the accelerator's x64-off default,
  and the only width the hand-written kernels (K1-K8) take;
- on the CPU, float64: the counterpart of x64 on, which the parity tests
  against ``ocm_tpu`` use.

``_device.as_tensor`` applies it: float64 data that comes from the host
(numpy, a CPU tensor) to a CUDA device with no explicit ``dtype=`` becomes
float32 there.  An entry point that launches an f32-only kernel refuses a
float64 request on CUDA (a float64 CUDA tensor, or ``dtype=torch.float64``)
with a ``ValueError`` that names the kernel.

``enable_x64`` and ``x64_enabled`` are not ported: torch has no global
width switch; each tensor carries its own dtype.

``debug_nans`` is ``utils.profiling.debug_nans`` (autograd's anomaly mode).
"""

from __future__ import annotations

import dataclasses

import torch

from ocm_tpu_torch.utils.profiling import debug_nans

__all__ = ["CompatFlags", "DEFAULT_COMPAT", "debug_nans", "stats_dtype"]


def stats_dtype(device) -> torch.dtype:
    """float32 on CUDA, float64 elsewhere (the CPU)."""
    return torch.float32 if torch.device(device).type == "cuda" \
        else torch.float64


@dataclasses.dataclass(frozen=True)
class CompatFlags:
    """Registry of the reference-behaviour compatibility switches.

    Each flag names a documented quirk of the reference (``docs/PARITY.md``).
    Defaults reproduce the reference so decisions match to numerical
    tolerance; the corrected behaviour is one argument away.  The
    operational switches live on the port's functions; this object only
    documents the mapping:

    - ``batch_qhf_stats`` -> ``models.vae_decision.decide_f(calibration=)``
      (quirk Q3: the Q/h/f dofs and critical values from the scored batch);
    - ``testset_f_moments`` -> ``models.vae_decision.decide_full_distance(
      moments=)`` (the full distance's Nh/Nq/fcrit from test-set moments);
    - ``vaesimca_percentile_limits`` -> reproduced inside
      ``models.vaesimca`` (quirk Q5; ``fit_vaesimca(classical_limits=)``
      takes the classical engines), and the related Q11 round trip is
      ``fit_vaesimca(compat_double_standardize=)``;
    - quirk Q7 ('dd' sharing the last class's dofs) is
      ``models.simca.SIMCA(compat_dd_shared_state=)``.
    """

    batch_qhf_stats: bool = True
    testset_f_moments: bool = True
    vaesimca_percentile_limits: bool = True


DEFAULT_COMPAT = CompatFlags()
