"""Training dynamics: per-stage and per-layer statistics, the gradient-noise
scale and loss-spike forensics (the port's own copy of the JAX package's
``utils/dynamics.py``).

- **Statistics** (:func:`stage_stats`, :func:`nonfinite_per_stage`):
  device reductions over a step's gradients, parameters and updates,
  attributed to pipeline stages by the port's layer-to-stage map (stage
  s holds layers ``s * L/S .. (s+1) * L/S - 1``; the embedding rides
  stage 0, the final norm and the head stage S - 1). The tensors are
  named as the model's parameters (``layers.{i}.…``, ``tok``, ``pos``,
  ``norm.…``, ``out.…``). The stats stay on the device; ``fit`` reads
  them at its log points, with the loss.
- **Gradient-noise scale** (:class:`GNSEstimator`): the pipeline's units
  each produce one microbatch's gradient of one stage, and
  ``make_pipeline_grad_fn(..., dynamics=True)`` sums their squared norms
  per microbatch; with the step's gradient norm that is the
  small/large-batch pair of McCandlish et al., "An Empirical Model of
  Large-Batch Training", at no extra backward.
- **Forensics** (:class:`ForensicRecorder`): a host ring of recent log
  points and batch digests; on a guard skip or a z-score loss spike it
  writes a versioned bundle next to the run's manifest.

The estimator, the recorder, the bundle and the ``dynamics`` section are
the JAX module's exactly (``tests/test_torch_dynamics.py``).
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import json
import math
import os
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

FORENSIC_SCHEMA_VERSION = 1
FORENSIC_TRIGGERS = ("anomaly", "loss_spike")


@dataclasses.dataclass(frozen=True)
class DynamicsConfig:
    """The dynamics options. ``gns``: sum each microbatch's squared
    gradient norm in the executor (``make_pipeline_grad_fn`` refuses it
    where the stages do not partition the parameters; False keeps the
    per-stage stats there). ``ema``: the GNS estimate's smoothing per log
    point. ``ring``: the forensic ring's length. ``spike_z`` /
    ``spike_warmup``: a loss spike is a z-score of at least ``spike_z``
    against the ring's earlier losses, once it holds ``spike_warmup``
    finite ones."""

    gns: bool = True
    ema: float = 0.9
    ring: int = 16
    spike_z: float = 6.0
    spike_warmup: int = 5


def as_dynamics_config(dynamics) -> Optional[DynamicsConfig]:
    """None | False | True | DynamicsConfig -> Optional[DynamicsConfig]."""
    if dynamics is None or dynamics is False:
        return None
    if dynamics is True:
        return DynamicsConfig()
    if isinstance(dynamics, DynamicsConfig):
        return dynamics
    raise TypeError(f"dynamics must be None, True, or a DynamicsConfig, "
                    f"got {dynamics!r}")


# ---------------------------------------------------------------------------
# Per-stage and per-layer statistics
# ---------------------------------------------------------------------------


def stage_of_name(name: str, n_layers: int, n_stages: int) -> int:
    """The stage a parameter named as in the model belongs to."""
    if name.startswith("layers."):
        return int(name.split(".")[1]) // (n_layers // n_stages)
    return 0 if name in ("tok", "pos") else n_stages - 1


class StageIndex:
    """Where each named tensor's statistics land: its stage, and its layer
    (off the layer stack: none), as device index tensors built once, so
    :func:`stage_stats` moves nothing from the host during a step.
    ``named`` maps the tensors' parameter names to tensors of their
    shapes (the model's parameters), in the order the stats receive
    them."""

    def __init__(self, named: Mapping[str, torch.Tensor], n_layers: int,
                 n_stages: int, device):
        if n_layers % n_stages:
            raise ValueError(f"n_layers={n_layers} must divide into "
                             f"{n_stages} stages")
        self.names = tuple(named)
        self.n_layers, self.n_stages = n_layers, n_stages
        stage = [stage_of_name(n, n_layers, n_stages) for n in self.names]
        layer = [int(n.split(".")[1]) if n.startswith("layers.") else -1
                 for n in self.names]
        pos = [i for i, lay in enumerate(layer) if lay >= 0]
        numel = [0.0] * n_stages
        for s, t in zip(stage, named.values()):
            numel[s] += t.numel()
        self.stage = torch.tensor(stage, dtype=torch.long, device=device)
        self.layer_pos = torch.tensor(pos, dtype=torch.long, device=device)
        self.layer = torch.tensor([layer[i] for i in pos], dtype=torch.long,
                                  device=device)
        self.numel = torch.tensor(numel, dtype=torch.float32, device=device)

    def per_stage(self, per_tensor: torch.Tensor,
                  reduce: str = "sum") -> torch.Tensor:
        """[S] f32: the per-tensor values summed (or their max) per
        stage."""
        out = torch.zeros(self.n_stages, dtype=torch.float32,
                          device=per_tensor.device)
        if reduce == "sum":
            return out.index_add_(0, self.stage, per_tensor)
        return out.scatter_reduce_(0, self.stage, per_tensor, "amax")

    def per_layer(self, per_tensor: torch.Tensor) -> torch.Tensor:
        """[L] f32: the layer stack's per-tensor values summed per layer."""
        out = torch.zeros(self.n_layers, dtype=torch.float32,
                          device=per_tensor.device)
        return out.index_add_(0, self.layer,
                              per_tensor.index_select(0, self.layer_pos))


def _norms(tensors: List[torch.Tensor], ord: float = 2.0) -> torch.Tensor:
    """Each tensor's norm, in f32 (one fused reduction)."""
    return torch.stack(torch._foreach_norm(tensors, ord,
                                           dtype=torch.float32))


def _count_nonfinite(index: StageIndex, n2: torch.Tensor,
                     n_inf: torch.Tensor) -> torch.Tensor:
    """[S] int32: the tensors with a non-finite element per stage, from
    their squared 2-norms and max-abs norms. A tensor holds a NaN iff its
    sum of squares is NaN (finite squares only overflow to +inf), an inf
    iff its max |x| is inf."""
    bad = (torch.isnan(n2) | torch.isinf(n_inf)).to(torch.int32)
    return torch.zeros(index.n_stages, dtype=torch.int32,
                       device=n2.device).index_add_(0, index.stage, bad)


def nonfinite_per_stage(n_layers: int, n_stages: int, model: nn.Module,
                        index: Optional[StageIndex] = None) -> torch.Tensor:
    """[S] int32 on the model's device: the (parameter, layer) units with a
    non-finite gradient, per pipeline stage (S = ``n_stages``, stage s
    holding layers ``s * L/S`` .. ``(s+1) * L/S - 1``). The embedding's
    parameters (``tok``, GPT-2's ``pos``) are charged to stage 0 and the
    head's (the final norm, ``out``) to stage S - 1, as the JAX function
    charges its ``embed`` and ``head`` leaves; a parameter without a
    gradient counts 0. Two fused norms on the device; zero everywhere
    means the step's gradients are clean. ``index``: a
    :class:`StageIndex` over the parameters that hold a gradient, built
    beforehand (built here when None, which copies its indices to the
    device)."""
    grads = {n: p.grad for n, p in model.named_parameters()
             if p.grad is not None}
    if not grads:
        return torch.zeros(n_stages, dtype=torch.int32,
                           device=model.tok.device)
    if index is None:
        index = StageIndex(grads, n_layers, n_stages, model.tok.device)
    elif index.names != tuple(grads):
        raise ValueError("the StageIndex was built over other tensors")
    g = list(grads.values())
    return _count_nonfinite(index, _norms(g).square(), _norms(g, math.inf))


def stage_stats(n_layers: int, n_stages: int,
                grads: Mapping[str, torch.Tensor],
                params: Optional[Mapping[str, torch.Tensor]] = None,
                updates: Optional[Mapping[str, torch.Tensor]] = None,
                nonfinite: Optional[torch.Tensor] = None,
                index: Optional[StageIndex] = None,
                mesh=None) -> Dict[str, torch.Tensor]:
    """Per-stage and per-layer statistics on the device (the JAX
    ``stage_stats``). ``grads``, ``params`` and ``updates`` map parameter
    names to tensors (one name set, in one order).

    Always: ``grad_norm`` (the whole gradient's, before clipping),
    ``grad_norm_per_stage`` [S], ``grad_max_per_stage`` [S] (max |g|),
    ``nonfinite_per_stage`` [S] int32 (the non-finite tensors of each
    stage, as :func:`nonfinite_per_stage` counts them; ``nonfinite``
    passes the count computed already, the guard's, which is the
    world's under a mesh) and ``grad_norm_per_layer`` [L] (the layer
    stack only). With ``params``: ``param_rms_per_stage`` [S]; with
    ``updates`` too, ``update_ratio_per_stage`` [S], ||update|| /
    ||param|| per stage. Non-finite values are not masked out of the
    norms.

    ``index``: a :class:`StageIndex` over these names built beforehand
    (built here when None, which copies its indices to the device).
    ``mesh``: a world's ``parallel.mesh.Mesh`` whose ranks hold their
    stages' tensors (``grads`` names a rank's own layers and, on pipe
    coordinate 0 only, the replicated ones); the sums and maxima are
    reduced over its pipe group, so every rank returns the world's
    statistics."""
    if index is None:
        index = StageIndex(grads, n_layers, n_stages,
                           next(iter(grads.values())).device)
    sums = StatSums(index, grads, params, nonfinite, mesh)
    if updates is not None:
        sums.add_updates(updates)
    return sums.stats()


class StatSums:
    """:func:`stage_stats` in two steps, for a train step whose update
    changes the gradients (clipping) and the parameters in place: the
    gradient and parameter sums are taken at construction, before the
    update, the update's by :meth:`add_updates` after it."""

    def __init__(self, index: StageIndex, grads: Mapping[str, torch.Tensor],
                 params: Optional[Mapping[str, torch.Tensor]] = None,
                 nonfinite: Optional[torch.Tensor] = None, mesh=None):
        if index.names != tuple(grads):
            raise ValueError("the StageIndex was built over other tensors")
        self.index, self.mesh = index, mesh
        g = list(grads.values())
        n2 = _norms(g).square()
        sums = {"g_sq": index.per_stage(n2), "l_sq": index.per_layer(n2)}
        n_inf = _norms(g, math.inf)
        mx = index.per_stage(n_inf, "amax")
        if params is not None:
            sums["p_sq"] = index.per_stage(
                _norms([params[n] for n in index.names]).square())
            sums["numel"] = index.numel.clone()
        reduce_nf = nonfinite is None
        if reduce_nf:
            nonfinite = _count_nonfinite(index, n2, n_inf)
        if mesh is not None:
            from ..parallel.mesh import PIPE_AXIS
            mesh.all_reduce(list(sums.values())
                            + ([nonfinite] if reduce_nf else []), PIPE_AXIS)
            mesh.all_reduce([mx], PIPE_AXIS, op="max")
        self.sums, self.mx, self.nonfinite = sums, mx, nonfinite

    def add_updates(self, updates: Mapping[str, torch.Tensor]) -> None:
        u_sq = self.index.per_stage(
            _norms([updates[n] for n in self.index.names]).square())
        if self.mesh is not None:
            from ..parallel.mesh import PIPE_AXIS
            self.mesh.all_reduce([u_sq], PIPE_AXIS)
        self.sums["u_sq"] = u_sq

    def stats(self) -> Dict[str, torch.Tensor]:
        sums = self.sums
        g_sq = sums["g_sq"]
        out = {
            "grad_norm": g_sq.sum().sqrt(),
            "grad_norm_per_stage": g_sq.sqrt(),
            "grad_max_per_stage": self.mx,
            "nonfinite_per_stage": self.nonfinite,
            "grad_norm_per_layer": sums["l_sq"].sqrt(),
        }
        if "p_sq" in sums:
            out["param_rms_per_stage"] = (sums["p_sq"] / sums["numel"]).sqrt()
            if "u_sq" in sums:
                out["update_ratio_per_stage"] = sums["u_sq"].sqrt() / (
                    sums["p_sq"].sqrt() + 1e-12)
        return out


# ---------------------------------------------------------------------------
# Gradient-noise scale
# ---------------------------------------------------------------------------


def gns_estimates(mean_sq_small: float, sq_big: float, batch_small: float,
                  batch_big: float) -> Tuple[float, float]:
    """The unbiased ``(|G|^2, tr(Sigma))`` pair from a small- and a
    large-batch squared norm (McCandlish et al., appendix A): ``E|g_B|^2
    = |G|^2 + tr(Sigma)/B`` for a batch of B samples, so two batch sizes
    give both unknowns. The small batch is one microbatch (of a data
    shard), the large one the whole step."""
    b, B = float(batch_small), float(batch_big)
    if not B > b:
        raise ValueError(f"need batch_big > batch_small, got {B} <= {b}")
    g2 = (B * sq_big - b * mean_sq_small) / (B - b)
    s = (mean_sq_small - sq_big) / (1.0 / b - 1.0 / B)
    return g2, s


class GNSEstimator:
    """The gradient-noise scale ``tr(Sigma) / |G|^2`` on the host, fed one
    ``(mean_m |g_m|^2, |G|^2)`` pair a log point; numerator and
    denominator are smoothed separately (EMA ``ema``). :meth:`value` is
    None before the first finite update and while the smoothed ``|G|^2``
    is not positive."""

    def __init__(self, batch_small: float, batch_big: float,
                 ema: float = 0.9):
        if not batch_big > batch_small > 0:
            raise ValueError(
                f"need batch_big > batch_small > 0, got "
                f"small={batch_small}, big={batch_big} (GNS needs at "
                f"least two microbatches per step)")
        self.batch_small = float(batch_small)
        self.batch_big = float(batch_big)
        self.ema = float(ema)
        self.g2_ema: Optional[float] = None
        self.s_ema: Optional[float] = None
        self.n_updates = 0

    def update(self, mean_sq_small: float, sq_big: float) -> Optional[float]:
        g2, s = gns_estimates(mean_sq_small, sq_big, self.batch_small,
                              self.batch_big)
        if not (math.isfinite(g2) and math.isfinite(s)):
            return self.value()  # a poisoned step must not wedge the EMA
        if self.g2_ema is None:
            self.g2_ema, self.s_ema = g2, s
        else:
            a = self.ema
            self.g2_ema = a * self.g2_ema + (1.0 - a) * g2
            self.s_ema = a * self.s_ema + (1.0 - a) * s
        self.n_updates += 1
        return self.value()

    def value(self) -> Optional[float]:
        if self.g2_ema is None or self.g2_ema <= 0.0:
            return None
        return self.s_ema / self.g2_ema


# ---------------------------------------------------------------------------
# Forensics: batch digests, spike detection, bundles
# ---------------------------------------------------------------------------


def batch_digest(*arrays) -> str:
    """Content digest of a batch (shape, dtype, bytes) for forensics. Pass
    host arrays (numpy, or CPU tensors): a tensor on the card is read back
    first, which synchronises."""
    h = hashlib.sha256()
    for a in arrays:
        if isinstance(a, torch.Tensor):
            a = a.detach().cpu().numpy()
        x = np.asarray(a)
        h.update(repr((x.shape, str(x.dtype))).encode())
        h.update(x.tobytes())
    return h.hexdigest()[:16]


def _jsonable(obj):
    """Tensor, numpy and non-finite leaves -> plain JSON types."""
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, torch.Tensor):
        obj = obj.detach().cpu().numpy()
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, np.generic):
        return obj.item()
    if isinstance(obj, float) and not math.isfinite(obj):
        return repr(obj)  # json has no NaN/inf; keep them readable
    return obj


class ForensicRecorder:
    """The host ring and the bundle writer. :meth:`note_batch` takes each
    step's batch digest; :meth:`observe` takes a log point's loss and
    stats, appends a ring entry and returns the z-score when the loss
    spikes against the ring (else None); :meth:`dump` writes a bundle
    under ``out_dir`` and remembers its path."""

    def __init__(self, out_dir: Optional[str] = None, ring: int = 16,
                 spike_z: float = 6.0, warmup: int = 5):
        self.out_dir = out_dir
        self.spike_z = float(spike_z)
        self.warmup = int(warmup)
        self.ring: collections.deque = collections.deque(maxlen=ring)
        self.digests: collections.deque = collections.deque(maxlen=ring)
        self.bundles: List[str] = []

    def note_batch(self, step: int, digest: str) -> None:
        self.digests.append({"step": int(step), "digest": digest})

    def observe(self, step: int, loss: float, stats: Optional[dict] = None,
                gns: Optional[float] = None) -> Optional[float]:
        prior = [r["loss"] for r in self.ring
                 if isinstance(r["loss"], float) and math.isfinite(r["loss"])]
        z = None
        loss = float(loss)
        if len(prior) >= self.warmup and math.isfinite(loss):
            mu = sum(prior) / len(prior)
            var = sum((x - mu) ** 2 for x in prior) / len(prior)
            # the epsilon scales with the mean, so a flat plateau (sd 0)
            # still triggers on a real jump
            z = (loss - mu) / (math.sqrt(var) + 1e-9 * (1.0 + abs(mu)))
        entry = {"step": int(step), "loss": loss, "gns": gns}
        if stats is not None:
            entry["grad_norm"] = float(np.asarray(stats["grad_norm"]))
        self.ring.append(entry)
        if z is not None and z >= self.spike_z:
            return z
        return None

    def dump(self, step: int, trigger: str, *, loss=None, z=None,
             stats: Optional[dict] = None, attribution: Optional[dict] = None,
             checkpoint: Optional[dict] = None) -> Optional[str]:
        """Write one bundle; returns its path (None without ``out_dir``:
        the ring is still kept)."""
        if trigger not in FORENSIC_TRIGGERS:
            raise ValueError(f"trigger must be one of {FORENSIC_TRIGGERS}, "
                             f"got {trigger!r}")
        bundle = {
            "schema_version": FORENSIC_SCHEMA_VERSION,
            "kind": "forensic_bundle",
            "trigger": trigger,
            "step": int(step),
            "loss": _jsonable(loss),
            "z": _jsonable(z),
            "stats": _jsonable(stats),
            "attribution": _jsonable(attribution),
            "ring": _jsonable(list(self.ring)),
            "batch_digests": _jsonable(list(self.digests)),
            "checkpoint": _jsonable(checkpoint),
        }
        validate_forensic_bundle(bundle)
        if self.out_dir is None:
            return None
        os.makedirs(self.out_dir, exist_ok=True)
        path = os.path.join(self.out_dir,
                            f"forensics_step{int(step):06d}_{trigger}.json")
        with open(path, "w") as fh:
            json.dump(bundle, fh, indent=1)
        self.bundles.append(path)
        return path


def validate_forensic_bundle(bundle) -> None:
    """Structural check of a forensic bundle; raises ValueError naming the
    field at fault."""

    def fail(msg):
        raise ValueError(f"invalid forensic bundle: {msg}")

    if not isinstance(bundle, dict):
        fail(f"expected dict, got {type(bundle).__name__}")
    if bundle.get("kind") != "forensic_bundle":
        fail(f"kind must be 'forensic_bundle', got {bundle.get('kind')!r}")
    if bundle.get("schema_version") != FORENSIC_SCHEMA_VERSION:
        fail(f"schema_version must be {FORENSIC_SCHEMA_VERSION}, got "
             f"{bundle.get('schema_version')!r}")
    if bundle.get("trigger") not in FORENSIC_TRIGGERS:
        fail(f"trigger must be one of {FORENSIC_TRIGGERS}, got "
             f"{bundle.get('trigger')!r}")
    if not isinstance(bundle.get("step"), int):
        fail(f"step must be an int, got {bundle.get('step')!r}")
    ring = bundle.get("ring")
    if not isinstance(ring, list):
        fail(f"ring must be a list, got {type(ring).__name__}")
    for i, row in enumerate(ring):
        if not isinstance(row, dict) or "step" not in row or "loss" not in row:
            fail(f"ring[{i}] must be a dict with step/loss, got {row!r}")
    digests = bundle.get("batch_digests")
    if not isinstance(digests, list):
        fail(f"batch_digests must be a list, got {type(digests).__name__}")
    for i, row in enumerate(digests):
        if (not isinstance(row, dict)
                or not isinstance(row.get("digest"), str)):
            fail(f"batch_digests[{i}] must carry a string digest, "
                 f"got {row!r}")
    attr = bundle.get("attribution")
    if attr is not None:
        if not isinstance(attr, dict):
            fail(f"attribution must be a dict or None, got "
                 f"{type(attr).__name__}")
        if not isinstance(attr.get("stage"), int):
            fail(f"attribution.stage must be an int, got "
                 f"{attr.get('stage')!r}")
        if not isinstance(attr.get("statistic"), str):
            fail(f"attribution.statistic must be a string, got "
                 f"{attr.get('statistic')!r}")


# ---------------------------------------------------------------------------
# The run report's section
# ---------------------------------------------------------------------------


def dynamics_section(n_stages: int, last_stats: Optional[dict] = None,
                     gns: Optional[float] = None, gns_updates: int = 0,
                     n_skipped_attributed: int = 0,
                     forensic_bundles=()) -> dict:
    """The manifest's ``dynamics`` section from host-read stats
    (``telemetry.validate_report`` checks its shape)."""
    section = {
        "n_stages": int(n_stages),
        "grad_norm_final": None,
        "gns": None if gns is None else float(gns),
        "gns_updates": int(gns_updates),
        "n_skipped_attributed": int(n_skipped_attributed),
        "per_stage": [],
        "forensic_bundles": [os.path.basename(p) for p in forensic_bundles],
    }
    if last_stats is not None:
        sv = {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                  else np.asarray(v))
              for k, v in last_stats.items() if k != "sq_mb"}
        section["grad_norm_final"] = float(sv["grad_norm"])
        for s in range(int(n_stages)):
            row = {"stage": s,
                   "grad_norm": float(sv["grad_norm_per_stage"][s]),
                   "grad_max": float(sv["grad_max_per_stage"][s]),
                   "nonfinite": int(sv["nonfinite_per_stage"][s])}
            if "param_rms_per_stage" in sv:
                row["param_rms"] = float(sv["param_rms_per_stage"][s])
            if "update_ratio_per_stage" in sv:
                row["update_ratio"] = float(
                    sv["update_ratio_per_stage"][s])
            section["per_stage"].append(row)
        section["grad_norm_per_layer"] = [
            float(x) for x in sv["grad_norm_per_layer"]]
    return section
