"""Input configuration, compatible with the reference JSON schema.

The reference's single source of truth is src/context/input_schema.json
(sections control/parameters/iterative_solver/mixer/settings/unit_cell/
nlcg/vcsqnm/hubbard) from which typed accessors are generated
(src/context/config.hpp). Here each section is a dataclass whose field names
and defaults match the schema keys, so reference input decks
(verification/test*/sirius.json) load unchanged.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any


@dataclasses.dataclass
class ControlConfig:
    # reference input_schema.json "control" section
    processing_unit: str = "auto"
    verbosity: int = 0
    verification: int = 0
    print_forces: bool = False
    print_stress: bool = False
    print_neighbors: bool = False
    output: str = "stdout:"
    mpi_grid_dims: list = dataclasses.field(default_factory=lambda: [1, 1])
    std_evp_solver_name: str = "auto"
    gen_evp_solver_name: str = "auto"
    fft_mode: str = "serial"
    reduce_gvec: bool = True
    rmt_max: float = 2.2
    spglib_tolerance: float = 1e-6
    cyclic_block_size: int = -1
    beta_chunk_size: int = 256
    beta_on_device: bool = False
    ortho_rf: bool = False
    save_rf: bool = False
    use_second_variation: bool = True
    # G-sharded band solve (slab FFT over the "g" mesh axis): "auto"
    # switches when the replicated projector+wave-function footprint
    # exceeds gshard_budget_bytes per device; True forces, False disables.
    # sirius_tpu extension (no reference analog: the reference distributes
    # G vectors via its MPI fft_mode="parallel" instead)
    gshard: object = "auto"
    gshard_budget_bytes: float = 2.0e9
    # fused device-resident SCF iteration (dft/fused.py): "auto" engages it
    # whenever the deck is in the supported regime (PP-PW batched band
    # solve, no Hubbard/PAW/mGGA, linear/Anderson mixing); False keeps the
    # per-iteration host path as a debug fallback. sirius_tpu extension.
    device_scf: object = "auto"
    # on-the-fly chunked beta projectors (ops/beta_chunked.py): "auto"
    # switches the band solve to chunk-generated projectors when the dense
    # [nbeta_total, ngk] table would exceed beta_chunk_budget_bytes; True
    # forces, False disables. sirius_tpu extension.
    beta_chunked: object = "auto"
    beta_chunk_budget_bytes: float = 2.0e9
    # SCF supervision & recovery (dft/recovery.py): on non-finite fields,
    # energy blow-up, or RMS growing for rms_divergence_iters consecutive
    # iterations, roll back to the last finite snapshot and escalate the
    # backoff ladder (flush mixer history -> halve beta / linear fallback
    # -> disable device_scf) up to max_recoveries times before aborting
    # with a structured diagnostic. sirius_tpu extension (the reference
    # relies on robust direct-minimization solvers instead).
    scf_supervision: bool = True
    max_recoveries: int = 3
    rms_divergence_iters: int = 8
    energy_blowup_tol: float = 1e4  # Ha; |dE| beyond this trips the sentinel
    # fused path: fetch the rollback snapshot every N iterations (the host
    # path snapshots every iteration for free)
    snapshot_every: int = 5
    # band-solve supervision: retry with a deeper subspace when
    # max residual norm exceeds band_residual_blowup; serial path falls
    # back to dense exact diagonalization when ngk <= exact_diag_max_ngk
    band_residual_blowup: float = 1e2
    exact_diag_max_ngk: int = 600
    # preemption safety: write an atomic mid-SCF checkpoint every N
    # iterations (0 disables) to autosave_path (default
    # <base_dir>/sirius_autosave.h5); run_scf(resume=path) restarts from it
    autosave_every: int = 0
    autosave_path: str = ""
    # job-scoped autosave naming: when autosave_tag is set the default
    # autosave path becomes <base_dir>/sirius_autosave.<tag>.h5 so jobs
    # sharing a workdir (the serving engine) do not clobber each other
    autosave_tag: str = ""
    # keep the last N rotated autosaves (path, path.1, ... path.N-1);
    # 0 keeps the historical single-file overwrite behaviour
    autosave_keep: int = 0
    # pad every k-point's |G+k| sphere up to a multiple of this quantum
    # (0 = exact ngk_max). Serving uses it to coalesce decks whose spheres
    # differ slightly into one executable-shape bucket.
    ngk_pad_quantum: int = 0
    # on abort, dump the supervisor diagnostic (sentinel, iteration,
    # last-good energies, ladder history) as JSON to this path ("" = off)
    diag_dump: str = ""
    # observability (sirius_tpu/obs): telemetry=False turns every metric
    # update into a no-op (overhead kill switch); events_path opens the
    # JSONL event sink (run manifest, per-iteration records, recovery
    # rungs, checkpoints, MD steps); trace_capture arms a jax.profiler
    # capture of the first trace_capture_steps SCF iterations, written as
    # a TensorBoard-readable trace directory at that path ("" = off)
    telemetry: bool = True
    events_path: str = ""
    trace_capture: str = ""
    trace_capture_steps: int = 5
    # span_fence: block_until_ready inside device-bound spans so the span
    # timeline attributes compute to the stage that launched it instead of
    # the first blocking readback (obs/spans.py). Costs a device sync per
    # stage — bench_regress turns it on; production leaves it off.
    span_fence: bool = False
    # collective_probe: on G-sharded runs, time each collective (halo
    # all_to_alls, local FFT, beta psum) as a separately-jitted probe at
    # the deck's shapes during setup, and use the per-call medians to
    # split scf.band_solve into .compute/.collective spans (dft/scf.py).
    # Costs a few probe compiles at startup; only active when telemetry
    # is on and the run is actually G-sharded.
    collective_probe: bool = True
    # numerics observatory (obs/numerics.py): numerics_probe runs the
    # per-stage precision-headroom shadow probes every
    # numerics_probe_every iterations on the host path and once at the
    # final iterate on either path ("scf.numerics_probe" span,
    # "numerics_probe" events, result["numerics"]). Off by default: the
    # probes re-evaluate stages at reduced precision, which is shadow
    # work production runs do not want per iteration.
    numerics_probe: bool = False
    numerics_probe_every: int = 10
    # convergence analytics (obs/forecast.py + dft/recovery.py):
    # forecast_enabled feeds the log-linear decay-rate fit, the
    # iterations-to-converge forecast ("scf_forecast" events, the
    # scf_forecast_iterations gauge) and the divergence early-warning
    # score. A warning score >= forecast_warning_threshold triggers a
    # proactive rollback snapshot on the fused path; a sustained run of
    # high scores (forecast_backoff_iters, default rms_divergence_iters/2
    # floored at 3) with the rms forecast_backoff_ratio above the streak
    # start fires the "forecast_divergence" sentinel BEFORE the
    # non-finite/rms sentinels would trip.
    forecast_enabled: bool = True
    forecast_warning_threshold: float = 0.5
    forecast_backoff_iters: int = 0  # 0 = derive from rms_divergence_iters
    forecast_backoff_ratio: float = 10.0
    # deadline feasibility (serve/scheduler.py): wall-clock deadline as a
    # unix timestamp (0 = none). run_scf compares it against the
    # forecasted remaining iterations x the recent iteration time and
    # emits "deadline_feasibility" events when the verdict changes.
    deadline_ts: float = 0.0
    # straggler watchdog (device-fault resilience, utils/devfail.py):
    # when enabled, run_scf compares each iteration's wall time against
    # the obs/costs.py analytic model and the run's own healthy-median
    # baseline; straggler_iters consecutive iterations more than
    # straggler_ratio slower preempt the run at a snapshot boundary
    # (StragglerPreempt) so the serving layer can finish the job on a
    # healthy slice. "auto" means OFF standalone and ON under serve
    # (serve/scheduler.py resolves it to True at job admission).
    straggler_detect: object = "auto"
    straggler_ratio: float = 4.0
    straggler_iters: int = 3


@dataclasses.dataclass
class ParametersConfig:
    # reference input_schema.json "parameters" section defaults
    electronic_structure_method: str = "pseudopotential"
    xc_functionals: list = dataclasses.field(default_factory=list)
    core_relativity: str = "dirac"
    valence_relativity: str = "zora"
    num_bands: int = -1
    num_fv_states: int = -1
    smearing_width: float = 0.01  # Ha
    smearing: str = "gaussian"
    pw_cutoff: float = 0.0  # bohr^-1, density/potential sphere
    gk_cutoff: float = 0.0  # bohr^-1, |G+k| sphere
    aw_cutoff: float = 0.0  # LAPW rgkmax
    lmax_apw: int = 8
    lmax_rho: int = 8
    lmax_pot: int = 8
    num_mag_dims: int = 0  # 0: none, 1: collinear, 3: non-collinear
    auto_rmt: int = 1
    ngridk: list = dataclasses.field(default_factory=lambda: [1, 1, 1])
    shiftk: list = dataclasses.field(default_factory=lambda: [0, 0, 0])
    vk: list = dataclasses.field(default_factory=list)
    num_dft_iter: int = 100
    energy_tol: float = 1e-6
    density_tol: float = 1e-6
    molecule: bool = False
    gamma_point: bool = False
    so_correction: bool = False
    hubbard_correction: bool = False
    use_symmetry: bool = True
    use_ibz: bool = True
    nn_radius: float = -1
    extra_charge: float = 0
    use_scf_correction: bool = True
    precision_wf: str = "fp64"
    precision_hs: str = "fp64"
    precision_gs: str = "auto"

    @property
    def num_spins(self) -> int:
        return 2 if self.num_mag_dims > 0 else 1

    @property
    def num_spinor_comp(self) -> int:
        return 2 if self.num_mag_dims == 3 else 1


@dataclasses.dataclass
class IterativeSolverConfig:
    # reference input_schema.json "iterative_solver" section
    type: str = "auto"  # davidson | exact | auto
    num_steps: int = 20
    subspace_size: int = 2
    locking: bool = True
    early_restart: float = 0.5
    energy_tolerance: float = 1e-2
    residual_tolerance: float = 1e-6
    relative_tolerance: float = 0
    empty_states_tolerance: float = 0
    min_tolerance: float = 1e-13
    converge_by_energy: int = 1
    min_num_res: int = 0
    num_singular: int = -1
    init_eval_old: bool = True
    init_subspace: str = "lcao"
    extra_ortho: bool = False
    min_occupancy: float = 1e-14
    tolerance_ratio: float = 0
    tolerance_scale: list = dataclasses.field(default_factory=lambda: [0.1, 0.5])


@dataclasses.dataclass
class MixerConfig:
    # reference input_schema.json "mixer" section
    type: str = "anderson"  # linear | anderson | anderson_stable | broyden2
    beta: float = 0.7
    beta0: float = 0.15
    max_history: int = 8
    beta_scaling_factor: float = 1.0
    use_hartree: bool = False
    rms_min: float = 1e-16


@dataclasses.dataclass
class SettingsConfig:
    # reference input_schema.json "settings" section (subset in use)
    nprii_vloc: int = 200
    nprii_beta: int = 20
    nprii_aug: int = 20
    nprii_rho_core: int = 20
    fft_grid_size: list = dataclasses.field(default_factory=lambda: [0, 0, 0])
    use_coarse_fft_grid: bool = True
    pseudo_grid_cutoff: float = 10.0
    fp32_to_fp64_rms: float = 0
    auto_enu_tol: float = 0
    sht_coverage: int = 0
    sht_lmax: int = -1
    simple_lapw_ri: bool = False
    smooth_initial_mag: bool = False
    real_occupation_matrix: bool = False
    xc_use_lapl: bool = False


@dataclasses.dataclass
class HubbardConfig:
    # reference input_schema.json "hubbard" section (subset in use)
    simplified: bool = False
    orthogonalize: bool = False
    normalize: bool = False
    full_orthogonalization: bool = False
    hubbard_subspace_method: str = "none"
    local: list = dataclasses.field(default_factory=list)
    nonlocal_: list = dataclasses.field(default_factory=list)
    local_constraint: list = dataclasses.field(default_factory=list)
    constraint_method: str = "energy"
    constrained_calculation: bool = False
    constraint_beta_mixing: float = 0.4
    constraint_error: float = 1e-2
    constraint_max_iteration: int = 10
    constraint_strength: float = 1.0


@dataclasses.dataclass
class MdConfig:
    # Born-Oppenheimer molecular dynamics (sirius_tpu/md/): every step is a
    # converged SCF + analytic forces; the SCF warm-starts from an ASPC-
    # extrapolated (rho, psi) and reuses the fused step executable across
    # steps (compile-once stepping). sirius_tpu extension — the reference
    # is driven as an MD engine by host codes (CP2K/QE) instead.
    dt_fs: float = 1.0  # time step [fs]
    num_steps: int = 100
    ensemble: str = "nve"  # nve | nvt_langevin | nvt_csvr
    temperature_k: float = 300.0  # init (and NVT target) temperature [K]
    thermostat_tau_fs: float = 100.0  # thermostat relaxation time [fs]
    # ASPC predictor depth: number of previous steps entering the density/
    # wave-function extrapolation (0/1 = reuse last step's state as-is)
    extrapolation_order: int = 3
    # aspc: Kolafa always-stable predictor(-corrector); poly: pure
    # polynomial extrapolation (higher order, less damping); off: cold
    # superposition-of-atoms start every step (debug / A-B baseline)
    extrapolation_kind: str = "aspc"
    extrapolate_psi: bool = True  # subspace-aligned psi extrapolation
    trajectory_path: str = ""  # extended-XYZ output ("" = don't write)
    seed: int = 42  # velocity init + thermostat noise (counter-based)
    remove_com: bool = True  # zero total momentum at init
    compute_stress: bool = False  # per-step stress tensor + pressure
    # MD steps between /md restart checkpoints (0 disables); the file is
    # control.autosave_path or <base_dir>/sirius_md_autosave[.tag].h5
    autosave_every: int = 1


@dataclasses.dataclass
class UnitCellConfig:
    lattice_vectors: list = dataclasses.field(default_factory=lambda: [[1, 0, 0], [0, 1, 0], [0, 0, 1]])
    lattice_vectors_scale: float = 1.0
    atom_types: list = dataclasses.field(default_factory=list)
    atom_files: dict = dataclasses.field(default_factory=dict)
    atoms: dict = dataclasses.field(default_factory=dict)
    atom_coordinate_units: str = "lattice"
    # in-memory species (label -> pseudo_potential dict), populated by the
    # array-based C API species construction (reference
    # sirius_add_atom_type_radial_function et al., sirius_api.cpp:2058-2338)
    # instead of atom_files; takes precedence over atom_files per label
    atom_data: dict = dataclasses.field(default_factory=dict)


_SECTION_TYPES = {
    "control": ControlConfig,
    "parameters": ParametersConfig,
    "iterative_solver": IterativeSolverConfig,
    "mixer": MixerConfig,
    "settings": SettingsConfig,
    "unit_cell": UnitCellConfig,
    "hubbard": HubbardConfig,
    "md": MdConfig,
}


@dataclasses.dataclass
class Config:
    control: ControlConfig = dataclasses.field(default_factory=ControlConfig)
    parameters: ParametersConfig = dataclasses.field(default_factory=ParametersConfig)
    iterative_solver: IterativeSolverConfig = dataclasses.field(default_factory=IterativeSolverConfig)
    mixer: MixerConfig = dataclasses.field(default_factory=MixerConfig)
    settings: SettingsConfig = dataclasses.field(default_factory=SettingsConfig)
    unit_cell: UnitCellConfig = dataclasses.field(default_factory=UnitCellConfig)
    hubbard: HubbardConfig = dataclasses.field(default_factory=HubbardConfig)
    md: MdConfig = dataclasses.field(default_factory=MdConfig)
    # sections parsed but not yet consumed (nlcg, vcsqnm)
    extra: dict = dataclasses.field(default_factory=dict)

    @staticmethod
    def from_dict(d: dict[str, Any]) -> "Config":
        cfg = Config()
        for sec, val in d.items():
            typ = _SECTION_TYPES.get(sec)
            if typ is None:
                cfg.extra[sec] = val
                continue
            section = getattr(cfg, sec)
            known = {f.name for f in dataclasses.fields(typ)}
            for k, v in val.items():
                key = "nonlocal_" if (sec == "hubbard" and k == "nonlocal") else k
                if key in known:
                    setattr(section, key, v)
                else:
                    cfg.extra.setdefault(sec, {})[k] = v
        return cfg

    def to_dict(self) -> dict:
        out = {}
        for sec in _SECTION_TYPES:
            out[sec] = dataclasses.asdict(getattr(self, sec))
        # merge back unknown sections/keys so round-trips are lossless
        for sec, val in self.extra.items():
            if sec in out and isinstance(val, dict):
                out[sec].update(val)
            else:
                out[sec] = val
        return out


def load_config(path_or_dict: str | dict) -> Config:
    if isinstance(path_or_dict, dict):
        return Config.from_dict(path_or_dict)
    with open(path_or_dict) as f:
        return Config.from_dict(json.load(f))
