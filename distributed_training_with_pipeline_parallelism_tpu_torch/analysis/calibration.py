"""Calibration: measured micro-probes against the analytic models (the
port's own copy of the JAX package's ``analysis/calibration.py``).

``analysis.cost_model`` and ``analysis.memory_model`` predict;
``utils.telemetry`` measures. This module tracks the error between them:

- **Probes**: :func:`run_probe` runs one short measured run (a few steps
  of a tiny model through the port's executor) for one
  :class:`ProbeSpec` (schedule family x microbatch count x backward
  policy x ``comm_overlap``) and records the measured step time, the
  stamped comm seconds and the allocator's peak beside every prediction
  the models quote (lockstep serial, optimistically overlapped,
  double-buffered ring, table-exact bubble, analytic peak bytes).
  :func:`probe_grid` gives the seeded grid ``probe.py`` runs.
- **Ledger**: probe rows append to a JSONL ledger, one canonical
  (sorted-key) line a probe, validated on write and on read
  (:func:`validate_ledger_row`; malformed lines are counted and
  reported, never dropped silently). The signed relative error is kept
  per axis and grouped by (backend, schedule family, backward policy)
  (:func:`group_errors`).
- **Corrections**: :func:`fit_corrections` fits per-hardware efficiency
  scalars, one for FLOPs and one for bandwidth, by least squares over the
  ledger (float64 normal equations over sorted rows, so the fit is
  bit-deterministic), kept as a versioned, fingerprinted artifact
  (:func:`correction_artifact`, :func:`load_correction_artifact`, which
  refuses a tampered payload). ``cost_model_section(...,
  correction=...)`` applies them: a step's prediction carries raw and
  corrected values.

Everything but :func:`run_probe` is host-side stdlib and numpy, and every
host function gives the JAX module's values and bytes for the same input.
Differences from the JAX module:

- The default ledger and artifact lie under ``calibration_out/`` (listed
  in ``.gitignore``), never under ``results/``: the JAX package's
  ``results/calibration_corrections.json`` holds factors fitted on its
  CPU proxy, whose preset has the port's CPU preset's name, and a port
  run must neither apply nor rewrite them. ``$DTPP_CALIBRATION_CORRECTIONS``
  overrides the artifact's path, as in JAX.
- :func:`run_probe` runs the JAX probe model, batch and sequence through
  the port's lockstep executor (``make_pipeline_grad_fn`` with the spec's
  ``comm_overlap``) on ``device`` (``"cuda"`` or ``"cpu"``, the row's
  ``backend``), timed by ``utils.metrics.run_train_iterations``; its
  measured comm seconds are the stamped ``critical_path``'s, its measured
  peak bytes ``torch.cuda.max_memory_allocated`` over the probe after
  ``reset_peak_memory_stats`` (None on the CPU; JAX: XLA's
  ``temp_bytes``). Every predicted field is JAX's for the same spec and
  seed (the weights are the port's own from the seed; no predicted field
  depends on them).
- :func:`reprice_row` prices a row on the hardware it was measured on
  (the card's preset, or the CPU proxy for a ``cpu_proxy`` row).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import re
from typing import Any, Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "CALIBRATION_SCHEMA_VERSION", "LEDGER_KIND",
    "CORRECTION_ARTIFACT_VERSION", "CORRECTION_ARTIFACT_KIND",
    "CALIBRATION_DIR", "DEFAULT_LEDGER_PATH", "DEFAULT_CORRECTIONS_PATH",
    "CORRECTIONS_ENV",
    "CalibrationError", "ProbeSpec", "probe_grid", "schedule_family",
    "signed_rel_err", "validate_ledger_row", "canonical_row_line",
    "deterministic_fields", "append_ledger_rows", "load_ledger",
    "group_errors", "CorrectionFactors", "fit_correction", "fit_corrections",
    "correction_artifact", "correction_artifact_bytes",
    "save_correction_artifact", "load_correction_artifact",
    "maybe_load_default_corrections", "row_from_cost_model",
    "backfill_row_from_history", "backfill_row_from_bench",
    "run_probe", "reprice_row", "calibration_section",
    "calibration_section_from_cost_model",
]

CALIBRATION_SCHEMA_VERSION = 1
LEDGER_KIND = "calibration_probe"
CORRECTION_ARTIFACT_VERSION = 1
CORRECTION_ARTIFACT_KIND = "calibration_correction"
CALIBRATION_DIR = "calibration_out"
DEFAULT_LEDGER_PATH = os.path.join(CALIBRATION_DIR, "calibration.jsonl")
DEFAULT_CORRECTIONS_PATH = os.path.join(CALIBRATION_DIR,
                                        "calibration_corrections.json")
CORRECTIONS_ENV = "DTPP_CALIBRATION_CORRECTIONS"

# Fitted efficiencies are clamped into a physically readable band: a
# scalar below the floor means the probe measured pure overhead (the
# fit is still recorded — the floor only stops a zero/negative divide),
# above 1.0 means the model *under*-prices work; 10x is a generous cap
# for model error before the fit itself should be distrusted.
EFFICIENCY_CLAMP = (1e-6, 10.0)


class CalibrationError(ValueError):
    """Located validation failure in a ledger row or correction artifact."""


# ---------------------------------------------------------------------------
# Probe specs and grids
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ProbeSpec:
    """One point of the probe grid.

    ``remat_backward`` is the executor's tri-state knob (None = auto →
    'remat' at D>1, False = force 'stored', True = force 'remat');
    split-backward schedules (ZBH1/ZBV) resolve to 'split' regardless.
    ``comm_overlap`` is the ring-hop discipline ("none"/"ring"); the
    double-buffered executor requires the unrolled tick loop, which
    the port's lockstep executor runs at any D."""

    schedule: str
    n_devices: int = 2
    n_virtual: int = 1
    n_microbatches: int = 4
    remat_backward: Optional[bool] = None
    comm_overlap: str = "none"

    @property
    def label(self) -> str:
        return (f"{self.schedule}[D={self.n_devices},V={self.n_virtual},"
                f"M={self.n_microbatches}]"
                f"/{_policy_of(self.schedule, self.remat_backward, self.n_devices)}"
                f"/{self.comm_overlap}")

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def _policy_of(schedule: str, remat_backward, n_devices: int) -> str:
    if schedule in ("ZBH1", "ZBV"):
        return "split"
    stored = remat_backward is False or (remat_backward is None
                                         and n_devices == 1)
    return "stored" if stored else "remat"


# The smoke grid: >= 8 configs spanning GPipe/1F1B/Interleaved x
# stored/remat/split x overlap on/off, the JAX grid. Two stages keep the
# probes micro (a probe measures model error, not scale); 'stored' at
# D>1 pairs only with comm_overlap="none", as the JAX double-buffered
# executor requires.
_SMOKE_GRID: Tuple[ProbeSpec, ...] = (
    ProbeSpec("GPipe", n_microbatches=2, remat_backward=False),
    ProbeSpec("GPipe", n_microbatches=4, remat_backward=True),
    ProbeSpec("GPipe", n_microbatches=2, remat_backward=True,
              comm_overlap="ring"),
    ProbeSpec("1F1B", n_microbatches=2, remat_backward=False),
    ProbeSpec("1F1B", n_microbatches=2, remat_backward=True,
              comm_overlap="ring"),
    ProbeSpec("Interleaved1F1B", n_virtual=2, n_microbatches=4,
              remat_backward=True),
    ProbeSpec("Interleaved1F1B", n_virtual=2, n_microbatches=2,
              remat_backward=True, comm_overlap="ring"),
    ProbeSpec("ZBH1", n_microbatches=4),
    ProbeSpec("ZBH1", n_microbatches=2, comm_overlap="ring"),
)

_GRIDS: Dict[str, Tuple[ProbeSpec, ...]] = {"smoke": _SMOKE_GRID}


def probe_grid(name: str = "smoke", seed: int = 0) -> List[ProbeSpec]:
    """The named grid in a seeded deterministic order.

    The permutation decorrelates probe order from the grid's order (so
    steady-state host effects do not bias one schedule family), while the
    same seed gives the same order and ledger rows byte-identical but for
    the measured fields."""
    try:
        grid = _GRIDS[name]
    except KeyError:
        raise CalibrationError(
            f"unknown probe grid {name!r}; available: {sorted(_GRIDS)}")
    perm = np.random.default_rng(seed).permutation(len(grid))
    return [grid[int(i)] for i in perm]


_FAMILIES = (
    (re.compile(r"^GPipe"), "GPipe"),
    (re.compile(r"^1F1B"), "1F1B"),
    (re.compile(r"^Interleaved"), "Interleaved"),
    (re.compile(r"^BFS"), "BFS"),
    (re.compile(r"^ZB"), "ZB"),
    (re.compile(r"^Searched"), "searched"),
)


def schedule_family(name: str) -> str:
    """Coarse family key for error grouping ("other" when unrecognized)."""
    for pat, fam in _FAMILIES:
        if pat.match(name or ""):
            return fam
    return "other"


# ---------------------------------------------------------------------------
# Ledger rows
# ---------------------------------------------------------------------------


def signed_rel_err(predicted, measured) -> Optional[float]:
    """(predicted - measured) / measured; None when either side is
    missing or the measurement is non-positive. Negative = the model
    under-predicts (optimistic), positive = over-predicts."""
    if predicted is None or measured is None:
        return None
    measured = float(measured)
    if measured <= 0.0 or not np.isfinite(measured):
        return None
    return (float(predicted) - measured) / measured


def _rel_err_block(predicted: Optional[Dict[str, Any]],
                   measured: Optional[Dict[str, Any]]) -> Optional[Dict[str, Any]]:
    """Per-axis signed error between matching keys of the two blocks."""
    if not predicted or not measured:
        return None
    out: Dict[str, Any] = {}
    for axis in ("step_s", "step_s_overlapped", "step_s_comm_overlap",
                 "comm_s", "peak_bytes"):
        m_axis = "step_s" if axis.startswith("step_s") else axis
        err = signed_rel_err(predicted.get(axis), measured.get(m_axis))
        if err is not None:
            out[axis] = err
    return out or None


# required key -> allowed types. "predicted"/"measured"/"rel_err"/
# "corrected" are dict-or-None; a missing *required* key or a wrong type
# is a hard CalibrationError so a truncated write can't masquerade as
# a probe.
_ROW_SCHEMA: Tuple[Tuple[str, tuple], ...] = (
    ("schema_version", (int,)),
    ("kind", (str,)),
    ("source", (str,)),
    ("t", (int, float)),
    ("name", (str,)),
    ("backend", (str,)),
    ("hardware", (str,)),
    ("cpu_proxy", (bool,)),
    ("schedule", (str,)),
    ("schedule_family", (str,)),
    ("backward_policy", (str,)),
    ("comm_overlap", (str,)),
    ("n_devices", (int,)),
    ("n_virtual", (int,)),
    ("n_microbatches", (int,)),
    ("batch_size", (int,)),
    ("seq_length", (int,)),
    ("predicted", (dict, type(None))),
    ("measured", (dict, type(None))),
    ("rel_err", (dict, type(None))),
    ("corrected", (dict, type(None))),
)

# Fields excluded from the determinism contract: everything measured
# (and everything derived from a measurement) plus the wall-clock stamp.
_MEASURED_FIELDS = ("t", "measured", "rel_err", "corrected")


def validate_ledger_row(row: Any, where: str = "row") -> Dict[str, Any]:
    """Schema-check one ledger row; returns it. Raises
    :class:`CalibrationError` naming the offending field."""
    if not isinstance(row, dict):
        raise CalibrationError(f"{where}: not a JSON object "
                               f"({type(row).__name__})")
    for key, types in _ROW_SCHEMA:
        if key not in row:
            raise CalibrationError(f"{where}: missing required field {key!r}")
        if not isinstance(row[key], types):
            raise CalibrationError(
                f"{where}: field {key!r} has type "
                f"{type(row[key]).__name__}, expected "
                f"{'/'.join(t.__name__ for t in types)}")
    if row["schema_version"] != CALIBRATION_SCHEMA_VERSION:
        raise CalibrationError(
            f"{where}: schema_version {row['schema_version']} != "
            f"{CALIBRATION_SCHEMA_VERSION}")
    if row["kind"] != LEDGER_KIND:
        raise CalibrationError(f"{where}: kind {row['kind']!r} != "
                               f"{LEDGER_KIND!r}")
    pred = row["predicted"]
    if pred is not None and "step_s" not in pred:
        raise CalibrationError(f"{where}: predicted block has no step_s")
    meas = row["measured"]
    if meas is not None and "step_s" not in meas:
        raise CalibrationError(f"{where}: measured block has no step_s")
    return row


def canonical_row_line(row: Dict[str, Any]) -> str:
    """The canonical (byte-deterministic) one-line encoding the ledger
    stores: sorted keys, minimal separators, no trailing spaces."""
    return json.dumps(row, sort_keys=True, separators=(",", ":"))


def deterministic_fields(row: Dict[str, Any]) -> Dict[str, Any]:
    """The row minus its measured-side fields — the part the determinism
    test requires to be byte-identical across same-seed probe runs."""
    return {k: v for k, v in row.items() if k not in _MEASURED_FIELDS}


def append_ledger_rows(path: str, rows: Iterable[Dict[str, Any]]) -> int:
    """Validate and append rows to the ledger; returns the count."""
    rows = [validate_ledger_row(r, f"append[{i}]")
            for i, r in enumerate(rows)]
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    with open(path, "a", encoding="utf-8") as fh:
        for row in rows:
            fh.write(canonical_row_line(row) + "\n")
    return len(rows)


def load_ledger(path: str, strict: bool = False
                ) -> Tuple[List[Dict[str, Any]], List[str]]:
    """Read the ledger: (valid rows, malformed-line descriptions).

    Malformed lines — bad JSON or schema violations — are never silently
    dropped: each contributes a located description (``strict=True``
    raises on the first instead). A missing file is an empty ledger."""
    rows: List[Dict[str, Any]] = []
    bad: List[str] = []
    if not os.path.exists(path):
        return rows, bad
    with open(path, "r", encoding="utf-8") as fh:
        for lineno, line in enumerate(fh, start=1):
            line = line.strip()
            if not line:
                continue
            where = f"{path}:{lineno}"
            try:
                rows.append(validate_ledger_row(json.loads(line), where))
            except (json.JSONDecodeError, CalibrationError) as e:
                if strict:
                    raise CalibrationError(f"{where}: {e}") from e
                bad.append(f"{where}: {e}")
    return rows, bad


def group_errors(rows: Sequence[Dict[str, Any]]) -> Dict[str, Dict[str, Any]]:
    """Signed step-time error grouped by backend|family|policy.

    Rows without both a prediction and a measurement contribute to the
    group's ``n`` (the ledger's coverage is part of the answer) but not
    to its medians."""
    groups: Dict[str, List[Optional[float]]] = {}
    for row in rows:
        key = "|".join((row["backend"], row["schedule_family"],
                        row["backward_policy"]))
        err = (row.get("rel_err") or {}).get("step_s")
        groups.setdefault(key, []).append(err)
    out: Dict[str, Dict[str, Any]] = {}
    for key in sorted(groups):
        errs = [e for e in groups[key] if e is not None]
        out[key] = {
            "n": len(groups[key]),
            "n_with_err": len(errs),
            "median_rel_err": float(np.median(errs)) if errs else None,
            "median_abs_rel_err":
                float(np.median(np.abs(errs))) if errs else None,
        }
    return out


# ---------------------------------------------------------------------------
# Correction factors: deterministic least squares + signed artifact
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CorrectionFactors:
    """Per-hardware efficiency scalars the roofline divides by.

    ``measured_step ~= compute_s / flops_efficiency
    + comm_s / bandwidth_efficiency`` — so a factor of 1.0 means the
    roofline was exact, 0.01 means the hardware delivered 1% of the
    modeled rate on these probes. ``n_rows``/``residual_rms`` record the
    fit's evidence so a consumer can weigh it."""

    hardware: str
    flops_efficiency: float
    bandwidth_efficiency: float
    n_rows: int
    residual_rms: float

    def summary(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def _clamp_eff(x: float) -> float:
    lo, hi = EFFICIENCY_CLAMP
    return float(min(max(x, lo), hi))


def fit_correction(rows: Sequence[Dict[str, Any]], hardware: str
                   ) -> Optional[CorrectionFactors]:
    """Least-squares fit of (flops, bandwidth) efficiency for one
    hardware name over its ledger rows.

    Model: ``measured = a * compute_s + b * comm_s`` with
    ``a = 1/e_flops``, ``b = 1/e_bw`` — solved by explicit 2x2 normal
    equations in float64 over *sorted* canonical rows, so the result is
    bit-deterministic for a given ledger regardless of row order. When
    the comm column is degenerate (all ~0, or collinear with compute,
    or the solve lands non-positive) it falls back to a pure-FLOPs fit
    with ``e_bw = 1.0``. None when no row has both sides."""
    pts: List[Tuple[str, float, float, float]] = []
    for row in rows:
        if row.get("hardware") != hardware:
            continue
        pred, meas = row.get("predicted"), row.get("measured")
        if not pred or not meas:
            continue
        c = pred.get("compute_s")
        k = pred.get("comm_s")
        m = meas.get("step_s")
        if c is None or m is None or float(m) <= 0 or float(c) <= 0:
            continue
        pts.append((canonical_row_line(deterministic_fields(row)),
                    float(c), 0.0 if k is None else float(k), float(m)))
    if not pts:
        return None
    pts.sort()
    comp = np.array([p[1] for p in pts], dtype=np.float64)
    comm = np.array([p[2] for p in pts], dtype=np.float64)
    meas = np.array([p[3] for p in pts], dtype=np.float64)

    def _flops_only() -> Tuple[float, float]:
        return float((comp * meas).sum() / (comp * comp).sum()), 1.0

    scc = float((comp * comp).sum())
    skk = float((comm * comm).sum())
    sck = float((comp * comm).sum())
    det = scc * skk - sck * sck
    if skk <= 0.0 or det <= 1e-12 * scc * max(skk, 1e-300):
        a, b = _flops_only()
    else:
        rhs_c = float((comp * meas).sum())
        rhs_k = float((comm * meas).sum())
        a = (rhs_c * skk - rhs_k * sck) / det
        b = (rhs_k * scc - rhs_c * sck) / det
        if a <= 0.0 or b <= 0.0:
            a, b = _flops_only()
    resid = a * comp + b * comm - meas
    return CorrectionFactors(
        hardware=hardware,
        flops_efficiency=_clamp_eff(1.0 / a),
        bandwidth_efficiency=_clamp_eff(1.0 / b),
        n_rows=len(pts),
        residual_rms=float(np.sqrt(np.mean(resid * resid))),
    )


def fit_corrections(rows: Sequence[Dict[str, Any]]
                    ) -> Dict[str, CorrectionFactors]:
    """One :class:`CorrectionFactors` per hardware name in the rows."""
    out: Dict[str, CorrectionFactors] = {}
    for hw in sorted({r.get("hardware") for r in rows
                      if isinstance(r.get("hardware"), str)}):
        fit = fit_correction(rows, hw)
        if fit is not None:
            out[hw] = fit
    return out


_CORRECTION_FIELDS = ("hardware", "flops_efficiency", "bandwidth_efficiency",
                      "n_rows", "residual_rms")


def _corrections_fingerprint(art: Dict[str, Any]) -> str:
    payload = {k: art.get(k) for k in
               ("artifact_version", "kind", "schema_version", "corrections")}
    blob = json.dumps(payload, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()


def correction_artifact(factors: Mapping[str, CorrectionFactors]
                        ) -> Dict[str, Any]:
    """Versioned, fingerprinted JSON artifact for a set of fitted
    corrections — the same interchange discipline as the schedule
    artifacts (``parallel.schedules``): the fingerprint signs the
    payload, the loader re-derives and rejects any tamper."""
    art: Dict[str, Any] = {
        "artifact_version": CORRECTION_ARTIFACT_VERSION,
        "kind": CORRECTION_ARTIFACT_KIND,
        "schema_version": CALIBRATION_SCHEMA_VERSION,
        "corrections": {hw: cf.summary() for hw, cf in sorted(factors.items())},
    }
    art["fingerprint"] = _corrections_fingerprint(art)
    return art


def correction_artifact_bytes(art: Dict[str, Any]) -> bytes:
    """Canonical (byte-deterministic) encoding of a correction artifact."""
    return (json.dumps(art, sort_keys=True) + "\n").encode()


def save_correction_artifact(art: Dict[str, Any], path: str) -> None:
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    with open(path, "wb") as fh:
        fh.write(correction_artifact_bytes(art))


def load_correction_artifact(source) -> Dict[str, CorrectionFactors]:
    """Load + verify a correction artifact (path or dict) into
    per-hardware :class:`CorrectionFactors`. Every failure is a located
    :class:`CalibrationError`."""
    if isinstance(source, dict):
        art, label = source, "<dict>"
    else:
        label = str(source)
        try:
            with open(source, "r", encoding="utf-8") as fh:
                art = json.load(fh)
        except OSError as e:
            raise CalibrationError(f"correction artifact {label}: "
                                   f"unreadable: {e}")
        except json.JSONDecodeError as e:
            raise CalibrationError(f"correction artifact {label}: "
                                   f"invalid JSON: {e}")
    if not isinstance(art, dict):
        raise CalibrationError(f"correction artifact {label}: not an object")
    if art.get("kind") != CORRECTION_ARTIFACT_KIND:
        raise CalibrationError(f"correction artifact {label}: kind "
                               f"{art.get('kind')!r} != "
                               f"{CORRECTION_ARTIFACT_KIND!r}")
    if art.get("artifact_version") != CORRECTION_ARTIFACT_VERSION:
        raise CalibrationError(
            f"correction artifact {label}: artifact_version "
            f"{art.get('artifact_version')!r} != "
            f"{CORRECTION_ARTIFACT_VERSION}")
    if art.get("fingerprint") != _corrections_fingerprint(art):
        raise CalibrationError(f"correction artifact {label}: fingerprint "
                               "mismatch (payload was modified)")
    corr = art.get("corrections")
    if not isinstance(corr, dict):
        raise CalibrationError(f"correction artifact {label}: corrections "
                               "is not an object")
    out: Dict[str, CorrectionFactors] = {}
    for hw, blob in corr.items():
        if not isinstance(blob, dict):
            raise CalibrationError(f"correction artifact {label}: "
                                   f"corrections[{hw!r}] is not an object")
        for field in _CORRECTION_FIELDS:
            if field not in blob:
                raise CalibrationError(
                    f"correction artifact {label}: corrections[{hw!r}] "
                    f"missing {field!r}")
        lo, hi = EFFICIENCY_CLAMP
        for field in ("flops_efficiency", "bandwidth_efficiency"):
            v = blob[field]
            if not isinstance(v, (int, float)) or not (lo <= v <= hi):
                raise CalibrationError(
                    f"correction artifact {label}: corrections[{hw!r}]"
                    f".{field}={v!r} outside clamp {EFFICIENCY_CLAMP}")
        out[hw] = CorrectionFactors(
            hardware=str(blob["hardware"]),
            flops_efficiency=float(blob["flops_efficiency"]),
            bandwidth_efficiency=float(blob["bandwidth_efficiency"]),
            n_rows=int(blob["n_rows"]),
            residual_rms=float(blob["residual_rms"]))
    return out


def maybe_load_default_corrections() -> Optional[Dict[str, CorrectionFactors]]:
    """Corrections from ``$DTPP_CALIBRATION_CORRECTIONS`` or the default
    :data:`DEFAULT_CORRECTIONS_PATH`; None when neither exists or the
    artifact fails verification. Never raises: a bad artifact degrades a
    training run to uncorrected predictions (``probe.py`` and
    :func:`load_correction_artifact` are where it is a hard error)."""
    path = os.environ.get(CORRECTIONS_ENV) or DEFAULT_CORRECTIONS_PATH
    if not os.path.exists(path):
        return None
    try:
        return load_correction_artifact(path)
    except CalibrationError:
        return None


# ---------------------------------------------------------------------------
# Row builders: probe, cost-model reports, backfill
# ---------------------------------------------------------------------------


def row_from_cost_model(cm: Dict[str, Any], *, source: str, name: str,
                        backend: str, t: float = 0.0,
                        seed: Optional[int] = None,
                        measured_comm_s: Optional[float] = None,
                        predicted_peak_bytes: Optional[float] = None,
                        measured_peak_bytes: Optional[float] = None
                        ) -> Dict[str, Any]:
    """Build one validated ledger row from a ``cost_model_section`` dict
    (which already pairs a predicted block with a measured one)."""
    hw = cm.get("hardware") or {}
    pred_src = cm.get("predicted") or {}
    meas_src = cm.get("measured")
    predicted: Optional[Dict[str, Any]] = None
    if pred_src:
        predicted = {k: pred_src.get(k) for k in
                     ("compute_s", "comm_s", "step_s", "step_s_overlapped",
                      "step_s_comm_overlap", "bubble_table_exact")}
        if predicted_peak_bytes is not None:
            predicted["peak_bytes"] = float(predicted_peak_bytes)
    measured: Optional[Dict[str, Any]] = None
    if meas_src and meas_src.get("step_s"):
        measured = {"step_s": float(meas_src["step_s"]),
                    "tokens_per_sec": meas_src.get("tokens_per_sec")}
        if measured_comm_s is not None:
            measured["comm_s"] = float(measured_comm_s)
        if measured_peak_bytes is not None:
            measured["peak_bytes"] = float(measured_peak_bytes)
    corrected = None
    corr_src = pred_src.get("corrected")
    if corr_src and measured:
        corrected = dict(corr_src)
        corrected["rel_err_step_s"] = signed_rel_err(
            corr_src.get("step_s"), measured["step_s"])
    row: Dict[str, Any] = {
        "schema_version": CALIBRATION_SCHEMA_VERSION,
        "kind": LEDGER_KIND,
        "source": source,
        "t": float(t),
        "name": name,
        "backend": backend,
        "hardware": str(hw.get("name", "unknown")),
        "cpu_proxy": bool(hw.get("cpu_proxy", False)),
        "schedule": str(cm.get("schedule", "unknown")),
        "schedule_family": schedule_family(str(cm.get("schedule", ""))),
        "backward_policy": str(cm.get("backward_policy", "unknown")),
        "comm_overlap": str(cm.get("comm_overlap", "none")),
        "n_devices": int(cm.get("n_devices", 0)),
        "n_virtual": int(cm.get("n_virtual", 1)),
        "n_microbatches": int(cm.get("n_microbatches", 0)),
        "batch_size": int(cm.get("batch_size", 0)),
        "seq_length": int(cm.get("seq_length", 0)),
        "predicted": predicted,
        "measured": measured,
        "rel_err": _rel_err_block(predicted, measured),
        "corrected": corrected,
    }
    if seed is not None:
        row["seed"] = int(seed)
    return validate_ledger_row(row, f"row_from_cost_model[{name}]")


def backfill_row_from_history(hrow: Dict[str, Any], *, path: str = "history"
                              ) -> Optional[Dict[str, Any]]:
    """One row of a perf history (JSONL of headline scalars) -> a ledger
    row, or None when it carries nothing calibratable (the caller prints
    the reason). A row with a measured step and no prediction is kept
    with ``predicted: null``: nothing is dropped silently."""
    meas_step = hrow.get("measured_step_s")
    pred_step = hrow.get("predicted_step_s")
    if meas_step is None and pred_step is None:
        return None
    schedule = str(hrow.get("schedule") or "unknown")
    backend = str(hrow.get("backend") or "unknown")
    predicted = None
    if pred_step is not None:
        predicted = {"step_s": float(pred_step), "compute_s": None,
                     "comm_s": None}
    measured = None
    if meas_step is not None:
        measured = {"step_s": float(meas_step),
                    "tokens_per_sec": hrow.get("tokens_per_sec")}
        if hrow.get("peak_temp_bytes") is not None:
            measured["peak_bytes"] = float(hrow["peak_temp_bytes"])
    row = {
        "schema_version": CALIBRATION_SCHEMA_VERSION,
        "kind": LEDGER_KIND,
        "source": f"backfill:{path}",
        "t": float(hrow.get("t") or 0.0),
        "name": str(hrow.get("name") or "history"),
        "backend": backend,
        "hardware": "cpu_proxy" if backend == "cpu" else "unknown",
        "cpu_proxy": backend == "cpu",
        "schedule": schedule,
        "schedule_family": schedule_family(schedule),
        "backward_policy": "unknown",
        "comm_overlap": "none",
        "n_devices": 0,
        "n_virtual": 1,
        "n_microbatches": 0,
        "batch_size": 0,
        "seq_length": 0,
        "predicted": predicted,
        "measured": measured,
        "rel_err": _rel_err_block(predicted, measured),
        "corrected": None,
    }
    return validate_ledger_row(row, f"backfill:{path}")


_BENCH_META = re.compile(
    r"\((?P<sched>[A-Za-z0-9_]+),.*?batch (?P<batch>\d+), "
    r"seq (?P<seq>\d+),.*?(?P<stages>\d+)-stage", re.S)


def backfill_row_from_bench(blob: Dict[str, Any], *, label: str
                            ) -> Optional[Dict[str, Any]]:
    """One bench wrapper (``{"rc", "parsed": {"metric", "value",
    "unit"}}``) -> a ledger row, or None when the run failed or parsed
    nothing (the caller reports the skip)."""
    parsed = blob.get("parsed")
    if not isinstance(parsed, dict) or parsed.get("value") in (None, 0):
        return None
    if parsed.get("unit") != "tokens/sec":
        return None
    meta = _BENCH_META.search(str(parsed.get("metric", "")))
    schedule = meta.group("sched") if meta else "unknown"
    batch = int(meta.group("batch")) if meta else 0
    seq = int(meta.group("seq")) if meta else 0
    stages = int(meta.group("stages")) if meta else 0
    tps = float(parsed["value"])
    measured = {"step_s": (batch * seq / tps) if batch and seq else None,
                "tokens_per_sec": tps}
    if measured["step_s"] is None:
        # tokens/sec alone can't be turned into a step time — keep the
        # throughput but there is no calibratable axis
        return None
    row = {
        "schema_version": CALIBRATION_SCHEMA_VERSION,
        "kind": LEDGER_KIND,
        "source": f"backfill:{label}",
        "t": 0.0,
        "name": label,
        "backend": "unknown",
        "hardware": "unknown",
        "cpu_proxy": False,
        "schedule": schedule,
        "schedule_family": schedule_family(schedule),
        "backward_policy": "unknown",
        "comm_overlap": "none",
        "n_devices": stages,
        "n_virtual": 1,
        "n_microbatches": 0,
        "batch_size": batch,
        "seq_length": seq,
        "predicted": None,       # bench wrappers predate the cost model rows
        "measured": measured,
        "rel_err": None,
        "corrected": None,
    }
    return validate_ledger_row(row, f"backfill:{label}")


# ---------------------------------------------------------------------------
# The measured micro-probe
# ---------------------------------------------------------------------------

# The JAX probe model: 4 layers divide both the 2-stage (V=1) and 4-stage
# (V=2) placements of the smoke grid; batch 8 divides every grid
# microbatch count.
_PROBE_MODEL = dict(dim=16, n_layers=4, n_heads=2, vocab_size=64,
                    ffn_dim=32, max_seq_len=16)
_PROBE_BATCH = 8
_PROBE_SEQ = 16


def run_probe(spec: ProbeSpec, *, seed: int = 0, num_iterations: int = 2,
              warmup_iterations: int = 1, correction=None,
              t: float = 0.0, detail: Optional[Dict[str, Any]] = None,
              device="cuda") -> Dict[str, Any]:
    """Run one measured micro-probe on ``device`` -> a validated ledger
    row.

    ``warmup_iterations`` untimed steps, then ``num_iterations`` timed
    ones (``utils.metrics.run_train_iterations``) of the probe model's
    loss and gradients through ``make_pipeline_grad_fn`` with the spec's
    schedule, backward and ``comm_overlap``, stamped by a
    ``utils.telemetry.PipelineTelemetry`` (the measured comm seconds: the
    critical path's over the timed steps, a step's share) and, on the
    card, the allocator's peak over the probe (the measured peak bytes).
    Weights and tokens come from ``seed``; the spec, the seed and every
    predicted field are JAX's. ``t`` stamps the row (0 by default, so a
    library caller stays deterministic). A dict ``detail`` receives the
    run's ``telemetry``, ``cost_model``, ``memory`` and
    ``compiled_schedule`` (``probe.py`` writes its annotated trace from
    them)."""
    import torch

    from ..models.transformer import init_params
    from ..parallel.pipeline import make_pipeline_grad_fn
    from ..parallel.schedules import compile_schedule
    from ..utils.config import ModelConfig, ScheduleConfig, resolve_device
    from ..utils.metrics import run_train_iterations
    from ..utils.telemetry import PipelineTelemetry, critical_path
    from .cost_model import (cost_model_section, detect_hardware,
                             resolve_backward_policy)
    from .memory_model import (allocator_stats, memory_model_section,
                               memory_probe_axes)

    device = resolve_device(device)
    cfg = ModelConfig(**_PROBE_MODEL)
    sched = ScheduleConfig(name=spec.schedule,
                           n_microbatches=spec.n_microbatches,
                           n_virtual=spec.n_virtual)
    cs = compile_schedule(spec.schedule, spec.n_devices, spec.n_virtual,
                          spec.n_microbatches)
    hw = detect_hardware(device)
    tel = PipelineTelemetry()
    grad_fn = make_pipeline_grad_fn(cfg, sched, spec.n_devices,
                                    remat_backward=spec.remat_backward,
                                    comm_overlap=spec.comm_overlap,
                                    telemetry=tel, device=device)
    model = init_params(cfg, torch.Generator().manual_seed(seed), device)
    gen = torch.Generator().manual_seed(seed + 1)
    tokens, targets = (torch.randint(0, cfg.vocab_size,
                                     (_PROBE_BATCH, _PROBE_SEQ),
                                     generator=gen).to(device)
                       for _ in range(2))

    def step(m, x, y):
        m.zero_grad(set_to_none=True)
        return grad_fn(m, x, y)

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    metrics = run_train_iterations(step, model, tokens, targets,
                                   num_iterations=num_iterations,
                                   warmup_iterations=warmup_iterations,
                                   telemetry=tel)
    allocator = allocator_stats(device)
    measured_step_s = metrics["elapsed_time"] / num_iterations
    measured_comm_s = None
    if tel.events:
        # the stamps cover the timed loop (reset after the warm-up)
        measured_comm_s = float(critical_path(tel)["comm_s"]) / num_iterations

    cm = cost_model_section(cs, cfg, batch_size=_PROBE_BATCH,
                            seq_length=_PROBE_SEQ, hardware=hw,
                            remat_backward=spec.remat_backward,
                            measured_step_s=measured_step_s,
                            comm_overlap=spec.comm_overlap,
                            correction=correction)
    mem = memory_model_section(cs, cfg, batch_size=_PROBE_BATCH,
                               seq_length=_PROBE_SEQ, hardware=hw,
                               remat_backward=spec.remat_backward,
                               allocator=allocator)
    peaks = memory_probe_axes(mem)

    policy = resolve_backward_policy(cs, spec.remat_backward, spec.n_devices)
    name = (f"probe_{spec.schedule}_D{spec.n_devices}V{spec.n_virtual}"
            f"M{spec.n_microbatches}_{policy}_{spec.comm_overlap}")
    if detail is not None:
        detail.update(telemetry=tel, cost_model=cm, memory=mem,
                      compiled_schedule=cs)
    return row_from_cost_model(
        cm, source="probe", name=name, backend=device.type, t=t, seed=seed,
        measured_comm_s=measured_comm_s,
        predicted_peak_bytes=peaks["predicted_peak_bytes"],
        measured_peak_bytes=peaks["measured_peak_bytes"])


def _row_hardware(row: Dict[str, Any]):
    """The preset a row was measured on: the CPU proxy for a
    ``cpu_proxy`` row, else the CUDA card's."""
    from .cost_model import CPU_PROXY, detect_hardware
    return CPU_PROXY if row.get("cpu_proxy") else detect_hardware("cuda")


def reprice_row(row: Dict[str, Any], spec: ProbeSpec, correction
                ) -> Dict[str, Any]:
    """Re-price one probe row under fitted corrections without measuring
    again: recompile the table (host numpy) and run the cost model with
    the correction, keeping the row's measured fields as they are
    (``probe.py`` reports corrected error from the run that fitted the
    correction: the measurement is the costly part, the pricing host
    math), on the preset of the hardware the row was measured on."""
    from ..parallel.schedules import compile_schedule
    from ..utils.config import ModelConfig
    from .cost_model import cost_model_section

    cfg = ModelConfig(**_PROBE_MODEL)
    cs = compile_schedule(spec.schedule, spec.n_devices, spec.n_virtual,
                          spec.n_microbatches)
    meas = row.get("measured") or {}
    pred_old = row.get("predicted") or {}
    cm = cost_model_section(cs, cfg, batch_size=row["batch_size"],
                            seq_length=row["seq_length"],
                            hardware=_row_hardware(row),
                            remat_backward=spec.remat_backward,
                            measured_step_s=meas.get("step_s"),
                            comm_overlap=spec.comm_overlap,
                            correction=correction)
    return row_from_cost_model(
        cm, source=row["source"], name=row["name"], backend=row["backend"],
        t=row["t"], seed=row.get("seed"),
        measured_comm_s=meas.get("comm_s"),
        predicted_peak_bytes=pred_old.get("peak_bytes"),
        measured_peak_bytes=meas.get("peak_bytes"))


# ---------------------------------------------------------------------------
# RunReport section
# ---------------------------------------------------------------------------


def _compact_row(row: Dict[str, Any]) -> Dict[str, Any]:
    pred = row.get("predicted") or {}
    meas = row.get("measured") or {}
    corr = row.get("corrected") or {}
    return {
        "schedule": row["schedule"],
        "schedule_family": row["schedule_family"],
        "backward_policy": row["backward_policy"],
        "comm_overlap": row["comm_overlap"],
        "n_devices": row["n_devices"],
        "n_microbatches": row["n_microbatches"],
        "predicted_step_s": pred.get("step_s"),
        "predicted_step_s_corrected": corr.get("step_s"),
        "measured_step_s": meas.get("step_s"),
        "rel_err": (row.get("rel_err") or {}).get("step_s"),
        "rel_err_corrected": corr.get("rel_err_step_s"),
    }


def calibration_section(rows: Sequence[Dict[str, Any]], *,
                        correction: Optional[Mapping[str, Any]] = None,
                        ledger_path: Optional[str] = None) -> Dict[str, Any]:
    """The schema-validated ``calibration`` RunReport section: compact
    per-config rows plus the raw-vs-corrected error summary."""
    compact = [_compact_row(validate_ledger_row(r, f"section[{i}]"))
               for i, r in enumerate(rows)]
    raw = [abs(c["rel_err"]) for c in compact if c["rel_err"] is not None]
    cor = [abs(c["rel_err_corrected"]) for c in compact
           if c["rel_err_corrected"] is not None]
    section: Dict[str, Any] = {
        "schema_version": CALIBRATION_SCHEMA_VERSION,
        "n_rows": len(compact),
        "rows": compact,
        "summary": {
            "n_with_predictions":
                sum(1 for c in compact if c["predicted_step_s"] is not None),
            "median_abs_rel_err_raw":
                float(np.median(raw)) if raw else None,
            "median_abs_rel_err_corrected":
                float(np.median(cor)) if cor else None,
            "groups": group_errors(rows),
        },
        "correction": None,
        "ledger_path": ledger_path,
    }
    if correction:
        section["correction"] = {
            hw: (cf.summary() if isinstance(cf, CorrectionFactors)
                 else dict(cf))
            for hw, cf in sorted(correction.items())}
    return section


def calibration_section_from_cost_model(cm: Dict[str, Any], *, backend: str,
                                        name: str = "run",
                                        correction: Optional[Mapping[str, Any]]
                                        = None) -> Optional[Dict[str, Any]]:
    """The one-row calibration section of a measured
    ``cost_model_section``: how ``fit`` and the sweep report their own
    predicted-against-measured point without a probe grid. None when the
    section holds no measurement."""
    if not (cm.get("measured") or {}).get("step_s"):
        return None
    row = row_from_cost_model(cm, source="run", name=name, backend=backend)
    return calibration_section([row], correction=correction)
