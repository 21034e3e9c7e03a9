"""Energy / latency cost model, the power-manager analogue (port of
``repro.core.energy``, the paper's Fig. 3 side).

X-HEEP's power manager implements clock gating, power gating and memory
retention; the paper's evaluation (Fig. 3) reports kernel-level speedup
and energy of {early exit on the CPU, NM-Carus offload, both} against
CPU-only execution. This module is the accounting layer: pure arithmetic
on exit rates and per-stage MAC / byte counts.

  * **Device profiles.** ``CPU_PROFILE`` and ``NM_CARUS_PROFILE`` are the
    paper's X-HEEP RISC-V microcontroller constants: the in-order RV32
    host (CV32E40P at 300 MHz, 0.8 V; 29 uW of leakage, paper Fig. 2) and
    the near-memory vector unit, its per-MAC constants calibrated to the
    paper's measured system ratios (3.4x kernel speedup, 2.2x energy for
    int8 GEMM-like kernels without early exit). They are the paper's
    figures for that chip, not measurements of any accelerator this
    package runs on; the JAX package's TPU constants are left out.
  * **Compute gating.** Early exit power-gates the skipped tail of the
    network: skipped MACs and bytes cost nothing, so each stage's cost is
    weighted by the measured exit rate.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Sequence

# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class DeviceProfile:
    name: str
    time_per_mac_s: float          # seconds per multiply-accumulate
    energy_per_mac_j: float        # joules per MAC (incl. fetch overheads)
    energy_per_byte_j: float       # joules per byte moved to/from memory
    static_power_w: float          # leakage while the domain is on


# CV32E40P-class host: 300 MHz, ~2 cycles/MAC effective (ld/ld/mac/st mix),
# energy per op dominated by IF + regfile + SRAM access.
CPU_PROFILE = DeviceProfile(
    name="cpu",
    time_per_mac_s=2.0 / 300e6,
    energy_per_mac_j=12e-12,
    energy_per_byte_j=1.2e-12,
    static_power_w=29e-6,          # paper Fig. 2: 29 uW total leakage
)

# NM-Carus: vector MACs executed inside the SRAM bank, calibrated to the
# paper's measured no-early-exit offload bars (Fig. 3): 3.4x kernel speedup
# and 2.2x energy gain on a GEMM-dominated int8 workload.
NM_CARUS_PROFILE = DeviceProfile(
    name="nm_carus",
    time_per_mac_s=2.0 / 300e6 / 3.4,
    energy_per_mac_j=12e-12 / 2.2,
    energy_per_byte_j=1.2e-12 / 2.2,
    static_power_w=8e-6,
)


# ---------------------------------------------------------------------------
# Workload costing
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class StageCost:
    """One network stage (e.g. "layers 0..k", "exit head", "layers k..L")."""

    name: str
    macs: float
    bytes_moved: float
    offloadable: bool = True       # GEMM-like => can run on the accelerator


def stage_time_energy(stage: StageCost, profile: DeviceProfile
                      ) -> Dict[str, float]:
    t = stage.macs * profile.time_per_mac_s
    e = (stage.macs * profile.energy_per_mac_j
         + stage.bytes_moved * profile.energy_per_byte_j)
    return {"time_s": t, "energy_j": e}


def run_configuration(stages: Sequence[StageCost],
                      exit_rate: float,
                      exit_stage: int,
                      offload: bool,
                      early_exit: bool) -> Dict[str, float]:
    """Cost one inference configuration (the four bars of Fig. 3).

    ``stages`` are in execution order; ``exit_stage`` is the index of the
    exit-head stage. With early exit on, stages AFTER the exit head run
    with probability (1 - exit_rate). With offload on, offloadable stages
    run on NM-Carus; control/overhead stages stay on the CPU.
    """
    t_total = 0.0
    e_total = 0.0
    for i, st in enumerate(stages):
        if early_exit and i > exit_stage:
            p_run = 1.0 - exit_rate
        elif not early_exit and i == exit_stage:
            continue                      # no exit head in the baseline nets
        else:
            p_run = 1.0
        prof = NM_CARUS_PROFILE if (offload and st.offloadable) else CPU_PROFILE
        c = stage_time_energy(st, prof)
        t_total += p_run * c["time_s"]
        e_total += p_run * c["energy_j"]
    # leakage for the duration of the run (host always on)
    e_total += CPU_PROFILE.static_power_w * t_total
    return {"time_s": t_total, "energy_j": e_total}


def improvement_table(stages: Sequence[StageCost], exit_rate: float,
                      exit_stage: int) -> Dict[str, Dict[str, float]]:
    """The paper's Fig. 3: everything normalized to CPU-only, no early
    exit."""
    base = run_configuration(stages, exit_rate, exit_stage, offload=False,
                             early_exit=False)
    out = {"cpu_baseline": {"speedup": 1.0, "energy_gain": 1.0}}
    for name, off, ee in (("cpu_early_exit", False, True),
                          ("nm_offload", True, False),
                          ("nm_offload_early_exit", True, True)):
        c = run_configuration(stages, exit_rate, exit_stage, offload=off,
                              early_exit=ee)
        out[name] = {
            "speedup": base["time_s"] / c["time_s"],
            "energy_gain": base["energy_j"] / c["energy_j"],
            "time_s": c["time_s"],
            "energy_j": c["energy_j"],
        }
    return out
