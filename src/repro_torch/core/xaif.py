"""XAIF op registry (PyTorch port): one op name, two backends.

The JAX package dispatches each op (``gemm``, ``rmsnorm``, ``attention``,
``attn_decode``, ``attn_decode_paged``, ``verify_decode``,
``verify_decode_paged``, ``entropy_exit``, ``moe_decode``, ``ssm_scan``,
``ssm_decode``) through
``repro.core.xaif`` to a pure-jnp ``ref`` backend or a Pallas TPU kernel.
Here every op has

  * a PLAIN backend — straightforward PyTorch with the JAX ref's numerics,
    used for CPU tensors and as the oracle the kernels are held against;
  * a KERNEL backend — the wrapper of a hand-written CUDA kernel
    (``repro_torch/csrc/``). It raises on a CPU tensor and counts its own
    launches in ``wrapper.launches`` (a plain int).

An op's kernel wrapper may launch one of several kernels (``attn_decode``
launches the GQA kernel or, in precise mode, the MLA kernel); its counter
counts them all. The port adds one op the JAX package has not:
``gemm_heads``, the per-head fp32 products of MLA's absorbed decode and of
the xLSTM mixers' block-diagonal weights (plain einsums in JAX). The
``ssm_decode`` op has two modes, Mamba and mLSTM, each with its own kernel
behind the one wrapper and counter.

Each op's registration also carries JAX's ``cost_fn`` (flops and bytes of
a call from its dims: the autotuner's prior), a ``supports(shapes,
dtype)`` predicate stating the CUDA kernel's own limits (its instances and
its wrapper's checks, not the Pallas ones) and a description. No kernel
declares a tunable: the CUDA kernels derive their plans from the shapes.

``call(op, policy, *args)`` picks the backend from the device of the first
tensor argument: CUDA tensors launch the kernel, CPU tensors run the plain
version. Policy ``"ref"`` forces the plain version on any device. Under
``"auto"``, ``"ref"`` and a :class:`Policy`, nothing else moves a call:
there is no fallback from a kernel to the plain version, and no shape
bucket is computed. No
kernel has a backward (nor had the Pallas kernels), so a call that would
launch one on a tensor that requires grad, with autograd on, raises
instead of cutting the gradient: training runs under ``"ref"``.

An op may also carry further, named backends, each again a plain version
and a kernel: ``gemm`` has ``int8`` (W8A8: activations quantized per row,
integer products; the JAX ``gemm/pallas_int8``). Such a backend is
``lossy`` — it changes the model's numbers — so ``"auto"`` and ``"ref"``
never select it: only a policy that names it does, and
constructing one that names a lossy backend raises unless it says
``allow_lossy=True`` (the JAX registry audit's XR108). Two further
backends run the same PyTorch code on every device and have no kernel and
no launch counter: ``attention``'s ``blockwise`` (online softmax over
q/kv blocks) and ``ssm_scan``'s ``assoc`` (a chunked associative scan).
Model code passes the policy on without reading it.

SHAPE-AWARE DISPATCH (JAX's ``DispatchPolicy``): a :class:`DispatchPolicy`
maps (op, shape bucket) to a backend. The buckets are JAX's
(:func:`shape_bucket`: rows of the row ops, decode / prefill, the KV
extent, the expert count, the recurrence's mode). A policy names the
default backend's two versions ``"kernel"`` (what ``"auto"`` runs: the
kernel for CUDA tensors, the plain version for CPU tensors) and ``"ref"``
(the plain version on every device); the further backends keep their
registered names. Its ``default`` is ``"kernel"``, so an empty policy
serves as ``"auto"`` does (JAX's default is its ``ref``). A backend whose
``supports`` rejects a call's shapes falls back along JAX's chain (the
policy's default, then ``"ref"``), and each such fallback is counted in
:func:`fallback_counts`; no fallback happens on an exception, and a
predicate's own exception propagates. On CUDA tensors a call is never
moved to a plain version that the policy does not name: where the kernel
rejects the shapes and the policy's default is ``"kernel"``, the call
raises, as the kernel's wrapper does under ``"auto"``. Policies
persist as JSON marked ``"package": "repro_torch"``; a file the JAX
package wrote is refused (its backend names differ: ``pallas`` is the
port's ``kernel``, ``pallas_int8`` its ``int8``). ``core/autotune.py``
measures the backends per cell and writes such a policy.

CIRCUIT BREAKER (JAX's ``CircuitBreaker``): while one is installed
(``install_breaker``), a backend that raises an ``InjectedFault`` (the
``chaos`` backends' test vector, ``serve/faults.py``) inside ``call`` is
degraded around: the breaker pins the (op, shape bucket) cell to
``"ref"``, the plain version of the op's default backend, for the rest of
its lifetime, records one ``FaultEvent("circuit-breaker", ...)`` per trip
and re-runs the call there. Under a :class:`DispatchPolicy` the cell is
the call's bucket; under ``"auto"``, ``"ref"`` and a :class:`Policy` it
is ``"*"``, every shape of the op (JAX's with an ``AccelConfig``). Any
other exception propagates, breaker or not: a kernel that fails to build
or launch on the card is never hidden behind its plain version (JAX's
breaker acts at trace time on any error; the port's acts at every call,
kernels included, so it is narrower).
"""
from __future__ import annotations

import functools
import json
from collections import Counter
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Mapping, Optional, Tuple, Union

import torch

from repro_torch.dist.fault import FaultEvent, InjectedFault

POLICIES = ("auto", "ref")
# a DispatchPolicy's names of the default backend's kernel ("auto"'s
# choice: the kernel for CUDA tensors, the plain version for CPU tensors)
# and of its plain version on every device
KERNEL, REF = "kernel", "ref"
WILDCARD = "*"


@dataclass(frozen=True)
class OpEntry:
    name: str
    plain: Callable
    kernel: Callable
    lossy: bool = False
    # (dims...) -> {"flops", "hbm_bytes"}: the autotuner's prior
    cost_fn: Optional[Callable] = None
    # (shapes, dtype) -> bool: the shapes the kernel takes; None = any.
    # ``shapes`` are the shapes of the call's positional tensors
    supports: Optional[Callable] = None
    description: str = ""

    def accepts(self, shapes, dtype) -> bool:
        return self.supports is None or bool(self.supports(shapes, dtype))


_REGISTRY: Dict[str, OpEntry] = {}          # each op's default backend
_NAMED: Dict[Tuple[str, str], OpEntry] = {}  # (op, backend): the others
_BUILTINS = []          # set once the built-in ops modules are imported


def register(name: str, plain: Callable, kernel: Callable,
             backend: str = "default", lossy: bool = False, *,
             cost_fn: Optional[Callable] = None,
             supports: Optional[Callable] = None,
             description: str = "") -> None:
    """Register op ``name``'s default backend, or a further ``backend``
    (its launches are counted as ``<op>_<backend>`` when its kernel has a
    ``launches`` counter)."""
    e = OpEntry(name, plain, kernel, lossy, cost_fn, supports, description)
    if backend == "default":
        _REGISTRY[name] = e
    elif backend in (KERNEL, REF):
        raise ValueError(f"{backend!r} names the default backend of every "
                         f"op; a further backend needs another name")
    else:
        _NAMED[(name, backend)] = e
    _route.cache_clear()


def unregister(name: str, backend: str) -> None:
    """Drop op ``name``'s further ``backend`` (a default backend stays)."""
    if backend == "default":
        raise ValueError("an op's default backend cannot be unregistered")
    del _NAMED[(name, backend)]
    _route.cache_clear()


@dataclass(frozen=True)
class Policy:
    """A dispatch policy that names backends per op. ``backends`` maps an
    op to one of its registered backend names ("default" or a further
    one); unnamed ops take their default. ``mode`` is ``"auto"`` (kernels
    for CUDA tensors) or ``"ref"`` (plain versions everywhere). A lossy
    backend needs ``allow_lossy=True``. Frozen and hashable; ``backends``
    is stored as sorted pairs."""

    backends: Union[Mapping[str, str], Tuple[Tuple[str, str], ...]] = \
        field(default_factory=dict)
    allow_lossy: bool = False
    mode: str = "auto"

    def __post_init__(self):
        pairs = tuple(sorted((str(k), str(v))
                             for k, v in dict(self.backends).items()))
        object.__setattr__(self, "backends", pairs)
        if self.mode not in POLICIES:
            raise ValueError(f"unknown mode {self.mode!r}; expected one of "
                             f"{POLICIES}")
        for op, backend in pairs:
            e = entry(op, backend)
            if e.lossy and not self.allow_lossy:
                raise ValueError(
                    f"backend {backend!r} of {op!r} is lossy: the policy "
                    f"must say allow_lossy=True")

    def backend_for(self, op: str) -> str:
        return dict(self.backends).get(op, "default")


def _ensure_builtin_ops() -> None:
    # a flag, not "is the registry empty": importing one ops module
    # directly registers that op alone
    if _BUILTINS:
        return
    # the ops modules import no CUDA toolchain: kernels build at first launch
    from repro_torch.kernels.attn_decode import ops as _ad     # noqa: F401
    from repro_torch.kernels.entropy_exit import ops as _ee    # noqa: F401
    from repro_torch.kernels.flash_attention import ops as _fa  # noqa: F401
    from repro_torch.kernels.gemm import ops as _gemm          # noqa: F401
    from repro_torch.kernels.moe_decode import ops as _moe     # noqa: F401
    from repro_torch.kernels.paged_attention import ops as _pa  # noqa: F401
    from repro_torch.kernels.rmsnorm import ops as _rn         # noqa: F401
    from repro_torch.kernels.ssm_decode import ops as _sd      # noqa: F401
    from repro_torch.kernels.ssm_scan import ops as _ss        # noqa: F401
    from repro_torch.kernels.verify_decode import ops as _vd   # noqa: F401
    _BUILTINS.append(True)


def entry(name: str, backend: str = "default") -> OpEntry:
    _ensure_builtin_ops()
    if backend == "default":
        return _REGISTRY[name]
    if (name, backend) not in _NAMED:
        raise ValueError(f"op {name!r} has no backend {backend!r}")
    return _NAMED[(name, backend)]


def ops() -> Tuple[str, ...]:
    _ensure_builtin_ops()
    return tuple(sorted(_REGISTRY))


# ---------------------------------------------------------------------------
# Backends as a DispatchPolicy names them
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Backend:
    """Backend ``name`` of ``op`` as a :class:`DispatchPolicy` names it:
    ``entry``'s kernel for CUDA tensors and its plain version for CPU
    tensors, or (``plain``: ``"ref"``) the plain version on every device,
    which takes every shape."""

    op: str
    name: str
    entry: OpEntry
    plain: bool = False

    @property
    def lossy(self) -> bool:
        return self.entry.lossy

    def accepts(self, shapes, dtype) -> bool:
        return self.plain or self.entry.accepts(shapes, dtype)

    def function(self, args, kwargs) -> Callable:
        """What a call with ``args`` runs: the kernel for CUDA tensors
        (unless ``plain``), else the plain version."""
        return _version(self.op, self.entry, self.plain, args, kwargs)


def backend(op: str, name: str) -> Backend:
    """Backend ``name`` ("kernel", "ref" or a further one) of ``op``."""
    if name in (KERNEL, REF):
        return Backend(op, name, entry(op), name == REF)
    return Backend(op, name, entry(op, name))


def backends_for(op: str) -> Tuple[str, ...]:
    """The names a :class:`DispatchPolicy` can give ``op``."""
    _ensure_builtin_ops()
    return (KERNEL, REF) + tuple(sorted(b for (o, b) in _NAMED if o == op))


# ---------------------------------------------------------------------------
# Shape buckets (JAX's): coarse workload classes of a call's shapes
# ---------------------------------------------------------------------------


def _rows(shape) -> int:
    m = 1
    for d in shape[:-1]:
        m *= int(d)
    return m


def _rows_bucket(shapes, _dtype):
    m = _rows(shapes[0])
    if m <= 32:
        return "rows_s"          # decode-sized: a handful of rows
    if m <= 2048:
        return "rows_m"          # small-batch prefill
    return "rows_l"              # large prefill


def _attention_bucket(shapes, _dtype):
    # q is [B, Hq, T, D]; T == 1 is the decode step, anything longer prefill
    return "decode" if int(shapes[0][-2]) == 1 else "prefill"


def _ssm_bucket(shapes, _dtype):
    # u is [B, T, Din]
    return "decode" if int(shapes[0][1]) == 1 else "scan"


def _paged_bucket(shapes, _dtype):
    # (q [B, Hq, D], k_pages [P, Hkv, ps, D], v_pages, page_table [B, NP],
    # cache_pos): the resident KV extent NP * ps
    s = int(shapes[1][2]) * int(shapes[3][1])
    return "kv_s" if s <= 1024 else "kv_l"


def _decode_kv_bucket(shapes, _dtype):
    # (q [B, Hq, D], k [B, Hkv, S, D], v, cache_pos): the contiguous KV
    # extent S, on the paged op's boundary
    return "kv_s" if int(shapes[1][2]) <= 1024 else "kv_l"


def _ssm_decode_bucket(shapes, _dtype):
    # the Mamba step takes x [B, Din], the mLSTM step q [B, H, dh]
    return "mamba" if len(shapes[0]) == 2 else "mlstm"


def _moe_bucket(shapes, _dtype):
    # (x [B, d], expert_idx [B, K], gate [B, K], w_gate [E, d, h], ...):
    # the routed-expert count E
    return "e_s" if int(shapes[3][0]) <= 16 else "e_l"


_BUCKET_FNS: Dict[str, Callable] = {
    "gemm": _rows_bucket,
    "rmsnorm": _rows_bucket,
    "entropy_exit": _rows_bucket,
    "attention": _attention_bucket,
    "ssm_scan": _ssm_bucket,
    "ssm_decode": _ssm_decode_bucket,
    "attn_decode": _decode_kv_bucket,
    "attn_decode_paged": _paged_bucket,
    # the verify ops' q gains a K1 axis; k and page_table keep their places
    "verify_decode": _decode_kv_bucket,
    "verify_decode_paged": _paged_bucket,
    "moe_decode": _moe_bucket,
}

_OP_BUCKETS: Dict[str, Tuple[str, ...]] = {
    "gemm": ("rows_s", "rows_m", "rows_l"),
    "rmsnorm": ("rows_s", "rows_m", "rows_l"),
    "entropy_exit": ("rows_s", "rows_m", "rows_l"),
    "attention": ("decode", "prefill"),
    "ssm_scan": ("decode", "scan"),
    "ssm_decode": ("mamba", "mlstm"),
    "attn_decode": ("kv_s", "kv_l"),
    "attn_decode_paged": ("kv_s", "kv_l"),
    "verify_decode": ("kv_s", "kv_l"),
    "verify_decode_paged": ("kv_s", "kv_l"),
    "moe_decode": ("e_s", "e_l"),
}


@functools.lru_cache(maxsize=4096)
def _bucket(op: str, shapes, dtype) -> str:
    try:
        return _BUCKET_FNS.get(op, _rows_bucket)(shapes, dtype)
    except (IndexError, TypeError, ValueError):
        return WILDCARD


def shape_bucket(op: str, shapes, dtype=None) -> str:
    """Classify argument shapes into this op's workload bucket (JAX's
    classes; memoised). Ops without a bucket function (``gemm_heads``)
    take the row classes, as JAX gives an unknown op; malformed shapes
    take the wildcard bucket, which every policy resolves."""
    try:
        shapes = tuple(tuple(int(d) for d in s) for s in shapes)
    except (TypeError, ValueError):
        return WILDCARD
    return _bucket(op, shapes, dtype)


def op_buckets(op: str) -> Tuple[str, ...]:
    """The bucket names the autotuner enumerates for ``op``."""
    return _OP_BUCKETS.get(op, ("rows_s", "rows_m", "rows_l"))


def _shapes_of(args) -> Tuple[Tuple[int, ...], ...]:
    """The shapes of a call's positional tensors; a ``WeightQ`` gives its
    int8 tensor's."""
    shapes = []
    for a in args:
        if isinstance(a, torch.Tensor):
            shapes.append(tuple(a.shape))
        elif isinstance(getattr(a, "q", None), torch.Tensor):   # WeightQ
            shapes.append(tuple(a.q.shape))
    return tuple(shapes)


# ---------------------------------------------------------------------------
# DispatchPolicy: (op, bucket) -> backend, JSON-persistable
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class DispatchRule:
    """One cell of the table: which backend. JAX's rule also carries the
    Pallas block sizes to pass; no CUDA kernel of the port declares a
    tunable (ROADMAP 2.8), so the port's has none."""

    backend: str


_JAX_NAMES = "pallas -> kernel, pallas_int8 -> int8 (ref, blockwise, " \
             "assoc and chaos keep their names)"


@dataclass(frozen=True)
class DispatchPolicy:
    """(op, shape bucket) -> :class:`DispatchRule`. Lookup falls back
    (op, bucket) -> (op, "*") -> ``default``, which is "kernel" or "ref".
    A rule that names a lossy backend needs ``allow_lossy=True``. Frozen,
    hashable and losslessly JSON-serializable."""

    rules: Tuple[Tuple[str, str, DispatchRule], ...] = ()
    default: str = KERNEL
    allow_lossy: bool = False

    def __post_init__(self):
        norm = []
        for op, bucket, rule in self.rules:
            if not isinstance(rule, DispatchRule):
                rule = DispatchRule(rule)
            norm.append((str(op), str(bucket), rule))
        norm.sort(key=lambda t: (t[0], t[1]))
        object.__setattr__(self, "rules", tuple(norm))
        object.__setattr__(self, "_table",
                           {(o, b): r for o, b, r in self.rules})
        object.__setattr__(self, "_default_rule", DispatchRule(self.default))
        object.__setattr__(self, "_hash", hash(
            (self.rules, self.default, self.allow_lossy)))
        if self.default not in (KERNEL, REF):
            raise ValueError(f"default {self.default!r}: a policy's default "
                             f"is {KERNEL!r} or {REF!r}, the two names every "
                             f"op has")
        for op, bucket, rule in self.rules:
            if backend(op, rule.backend).lossy and not self.allow_lossy:
                raise ValueError(
                    f"backend {rule.backend!r} of {op!r} (bucket {bucket}) "
                    f"is lossy: the policy must say allow_lossy=True")

    def __hash__(self) -> int:
        return self._hash

    # -- construction -------------------------------------------------------

    @classmethod
    def make(cls, table: Mapping, *, default: str = KERNEL,
             allow_lossy: bool = False) -> "DispatchPolicy":
        """Build from {(op, bucket): backend name | rule}. A plain-string
        key ``op`` means the wildcard bucket."""
        rules = []
        for key, val in dict(table).items():
            op, bucket = key if isinstance(key, tuple) else (key, WILDCARD)
            rules.append((op, bucket, val))
        return cls(rules=tuple(rules), default=default,
                   allow_lossy=allow_lossy)

    @classmethod
    def from_policy(cls, policy) -> "DispatchPolicy":
        """``"auto"``, ``"ref"`` or a :class:`Policy` as a wildcard-bucket
        policy (JAX's ``from_accel``). A ``"ref"``-mode Policy that names
        a further backend has no counterpart (a DispatchPolicy runs a
        further backend's kernel on CUDA tensors) and raises."""
        if isinstance(policy, Policy):
            named = {op: b for op, b in policy.backends if b != "default"}
            if policy.mode == REF:
                if named:
                    raise ValueError(f"{policy}: a 'ref'-mode Policy that "
                                     f"names {named} has no DispatchPolicy")
                return cls(default=REF)
            return cls.make(named, allow_lossy=policy.allow_lossy)
        if policy in POLICIES:
            return cls(default=KERNEL if policy == "auto" else REF)
        raise ValueError(f"unknown policy {policy!r}; expected one of "
                         f"{POLICIES}, a Policy or a DispatchPolicy")

    # -- lookup -------------------------------------------------------------

    def rule_for(self, op: str, bucket: str) -> DispatchRule:
        table = self._table
        rule = table.get((op, bucket))
        if rule is None:
            rule = table.get((op, WILDCARD))
        return rule if rule is not None else self._default_rule

    def backend_for(self, op: str, bucket: str = WILDCARD) -> str:
        return self.rule_for(op, bucket).backend

    # -- serialization ------------------------------------------------------

    def to_json(self, **extra) -> str:
        doc = {
            "package": "repro_torch",
            "version": 2,
            "default": self.default,
            "allow_lossy": self.allow_lossy,
            "rules": [
                {"op": o, "bucket": b, "backend": r.backend}
                for o, b, r in self.rules
            ],
        }
        doc.update(extra)
        return json.dumps(doc, indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "DispatchPolicy":
        """A policy this package wrote; extra keys (an autotune's
        measurements) are ignored. A file without ``"package":
        "repro_torch"``, such as one the JAX package wrote, is refused."""
        doc = json.loads(s)
        if doc.get("package") != "repro_torch":
            raise ValueError(
                f"a dispatch policy of package {doc.get('package')!r}, not "
                f"'repro_torch' (the JAX package writes no 'package' key): "
                f"its backend names are not the port's ({_JAX_NAMES}); "
                f"tune one with repro_torch.core.autotune")
        rules = tuple((r["op"], r["bucket"], DispatchRule(r["backend"]))
                      for r in doc.get("rules", ()))
        return cls(rules=rules, default=str(doc.get("default", KERNEL)),
                   allow_lossy=bool(doc.get("allow_lossy", False)))

    def save(self, path, **extra) -> None:
        with open(path, "w") as f:
            f.write(self.to_json(**extra))

    @classmethod
    def load(cls, path) -> "DispatchPolicy":
        with open(path) as f:
            return cls.from_json(f.read())


PolicyLike = Union[str, Policy, DispatchPolicy]


# ---------------------------------------------------------------------------
# Resolution + dispatch
# ---------------------------------------------------------------------------

# (op, bucket, rule's backend, backend run) -> calls since the last reset
_FALLBACKS: Counter = Counter()


def fallback_counts() -> Dict[Tuple[str, str, str, str], int]:
    """Calls that a :class:`DispatchPolicy` moved off the backend its rule
    names, because that backend's ``supports`` rejected their shapes, per
    (op, bucket, rule's backend, backend run), since the last
    :func:`reset_launch_counts`."""
    return dict(_FALLBACKS)


def _accepting_fallback(op: str, policy: DispatchPolicy, shapes,
                        dtype) -> Backend:
    """JAX's chain when a rule's backend rejects the shapes: the policy's
    default, then "ref". "ref" exists for every op and takes every shape,
    so JAX's further links (any accepting backend, non-lossy first) are
    never reached here."""
    b = backend(op, policy.default)
    return b if b.accepts(shapes, dtype) else backend(op, REF)


def resolve(op: str, policy: PolicyLike, shapes=None,
            dtype=None) -> Backend:
    """The backend a call with ``shapes`` would dispatch to. Under a
    :class:`DispatchPolicy` ``shapes`` select the bucket (omitted or
    malformed: the wildcard) and a rejecting backend falls back, as
    :func:`call` routes it; under the other policies the answer is
    shape-independent."""
    if not isinstance(policy, DispatchPolicy):
        return backend(op, DispatchPolicy.from_policy(policy).backend_for(op))
    try:
        shapes = tuple(tuple(int(d) for d in s) for s in shapes or ())
    except (TypeError, ValueError):
        shapes = ()
    if not shapes:
        return backend(op, policy.backend_for(op))
    return _route(op, policy, shapes, dtype)[1]


def _version(op: str, e: OpEntry, plain: bool, args, kwargs) -> Callable:
    """``e``'s plain version (``plain``, or CPU tensors) or its kernel."""
    device = next(a.device for a in args if isinstance(a, torch.Tensor))
    if plain or device.type == "cpu":
        return e.plain
    if torch.is_grad_enabled() and any(
            isinstance(a, torch.Tensor) and a.requires_grad
            for a in args + tuple(kwargs.values())):
        raise RuntimeError(
            f"xaif: op {op!r} would launch its CUDA kernel on a tensor "
            f"that requires grad, and no kernel has a backward: the "
            f"gradient would stop here. Train under the 'ref' policy, "
            f"or run inference under torch.no_grad()")
    return e.kernel


@functools.lru_cache(maxsize=65536)
def _route(op: str, policy: DispatchPolicy, shapes, dtype):
    """Where ``policy`` sends a call of ``op`` with ``shapes`` (a tuple of
    int tuples) and ``dtype``: (bucket, backend, the rule's backend if a
    ``supports`` fallback moved the call else None). Memoised: a step's
    calls repeat a few shapes (cleared when the registry changes)."""
    bucket = _bucket(op, shapes, dtype)
    rule = policy.backend_for(op, bucket)
    b = backend(op, rule)
    if b.accepts(shapes, dtype):
        return bucket, b, None
    return bucket, _accepting_fallback(op, policy, shapes, dtype), rule


def _dispatch(op: str, policy: DispatchPolicy, args, kwargs):
    """(bucket, backend name, function) of a call under ``policy``. A
    call on CUDA tensors that the chain would move to ``"ref"`` only
    because the kernel rejects its shapes raises instead."""
    shapes = _shapes_of(args)
    dtype = next((a.dtype for a in args if isinstance(a, torch.Tensor)),
                 None)
    bucket, b, moved = _route(op, policy, shapes, dtype)
    fn = b.function(args, kwargs)
    if moved is not None:
        if (b.plain and policy.default == KERNEL and next(
                a.device for a in args
                if isinstance(a, torch.Tensor)).type != "cpu"):
            raise ValueError(
                f"xaif: op {op!r}'s kernel does not take shapes {shapes} "
                f"({dtype}); a DispatchPolicy moves a call on the card to "
                f"the plain version only where it names 'ref'")
        _FALLBACKS[(op, bucket, moved, b.name)] += 1
    return bucket, b.name, fn


def call(op: str, policy: PolicyLike, *args, **kwargs):
    """Dispatch ``op`` to the backend ``policy`` names for it: under a
    :class:`DispatchPolicy`, its rule for the call's shape bucket (see the
    module docstring); otherwise the default backend unless a
    :class:`Policy` names another: its kernel for CUDA tensors under mode
    ``"auto"``, its plain version for CPU tensors or under ``"ref"``.
    With a :class:`CircuitBreaker` installed, a cell it pinned runs the
    plain version of the default backend, and a backend that raises an
    ``InjectedFault`` trips the breaker and the call is re-run there; any
    other exception propagates."""
    if isinstance(policy, DispatchPolicy):
        bucket, name, fn = _dispatch(op, policy, args, kwargs)
    else:
        if isinstance(policy, Policy):
            mode, name = policy.mode, policy.backend_for(op)
        elif policy in POLICIES:
            mode, name = policy, "default"
        else:
            raise ValueError(f"unknown policy {policy!r}; expected one of "
                             f"{POLICIES}, a Policy or a DispatchPolicy")
        bucket = WILDCARD
        fn = _version(op, entry(op, name), mode == "ref", args, kwargs)
    breaker = _BREAKER
    if breaker is None:
        return fn(*args, **kwargs)
    fallback = entry(op).plain
    if (op, bucket) in breaker.pinned or fn is fallback:
        return fallback(*args, **kwargs)
    try:
        return fn(*args, **kwargs)
    except InjectedFault as exc:     # degrade, counted and logged
        breaker.trip(op, bucket, name, exc)
    return fallback(*args, **kwargs)


class CircuitBreaker:
    """Pins (op, bucket) cells whose backend raised an ``InjectedFault``
    inside :func:`call` to ``"ref"``, the plain version of the op's
    default backend, as JAX's pins them to its ``ref``.

    A trip is permanent for the breaker's lifetime: the failed backend is
    not retried mid-stream. Each trip adds one to ``trips`` and logs one
    :class:`FaultEvent` (kind ``"circuit-breaker"``) into ``events``,
    which may be shared with a ``FaultInjector`` so that one timeline holds
    the injected faults and the degradations they caused. ``pinned`` maps
    each pinned (op, bucket) to ``"ref"``; the bucket is ``"*"`` for a
    call under a policy other than a :class:`DispatchPolicy`."""

    def __init__(self, events: Optional[List[FaultEvent]] = None):
        self.pinned: Dict[Tuple[str, str], str] = {}
        self.events = events if events is not None else []
        self.trips = 0

    def trip(self, op: str, bucket: str, backend: str,
             exc: Exception) -> None:
        self.pinned[(op, bucket)] = REF
        self.trips += 1
        self.events.append(FaultEvent(
            "circuit-breaker", self.trips,
            f"op={op} bucket={bucket} backend={backend} -> plain: "
            f"{type(exc).__name__}: {exc}"))


_BREAKER: Optional[CircuitBreaker] = None


def install_breaker(breaker: Optional[CircuitBreaker]
                    ) -> Optional[CircuitBreaker]:
    """Install ``breaker`` as the process-wide circuit breaker (None to
    remove it). Returns the previous one, so callers can put it back."""
    global _BREAKER
    prev, _BREAKER = _BREAKER, breaker
    return prev


def active_breaker() -> Optional[CircuitBreaker]:
    return _BREAKER


def _counters():
    """(counter name, kernel wrapper) of every backend with a kernel. A
    default backend's counter is its op's name, another's
    ``<op>_<backend>``; a backend without a kernel (``blockwise``,
    ``assoc``: the same PyTorch code on every device) has none."""
    _ensure_builtin_ops()
    out = [(name, _REGISTRY[name].kernel) for name in sorted(_REGISTRY)]
    out += [(f"{op}_{b}", e.kernel) for (op, b), e in sorted(_NAMED.items())
            if hasattr(e.kernel, "launches")]
    return out


def launch_counts() -> Dict[str, int]:
    """Kernel launches per backend since the last reset. A wrapper that
    launches one of several kernel instances may also count each apart
    (``wrapper.instances``: instance name -> launches)."""
    counts = {}
    for name, kernel in _counters():
        counts[name] = kernel.launches
        counts.update(getattr(kernel, "instances", {}))
    return counts


def reset_launch_counts() -> None:
    """Zero every launch counter and :func:`fallback_counts`."""
    for _, kernel in _counters():
        kernel.launches = 0
        for k in getattr(kernel, "instances", {}):
            kernel.instances[k] = 0
    _FALLBACKS.clear()
