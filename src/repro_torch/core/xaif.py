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

``call(op, policy, *args)`` picks the backend from the device of the first
tensor argument: CUDA tensors launch the kernel, CPU tensors run the plain
version. Policy ``"ref"`` forces the plain version on any device; nothing
else does — there is no fallback from a kernel to the plain version.
An installed :class:`CircuitBreaker` (below;
``serve_resilient(breaker=...)`` installs one for a stream) degrades only
around an injected fault, and counts and logs every trip. No
kernel has a backward (nor had the Pallas kernels), so a call that would
launch one on a tensor that requires grad, with autograd on, raises
instead of cutting the gradient: training runs under ``"ref"``.

An op may also carry further, named backends, each again a plain version
and a kernel: ``gemm`` has ``int8`` (W8A8: activations quantized per row,
integer products; the JAX ``gemm/pallas_int8``). Such a backend is
``lossy`` — it changes the model's numbers — so ``"auto"`` and ``"ref"``
never select it: only a :class:`Policy` that names it does, and
constructing one that names a lossy backend raises unless it says
``allow_lossy=True`` (the JAX registry audit's XR108). Model code passes
the policy on without reading it.

CIRCUIT BREAKER (JAX's ``CircuitBreaker``): while one is installed
(``install_breaker``), a backend that raises an ``InjectedFault`` (the
``chaos`` backends' test vector, ``serve/faults.py``) inside ``call`` is
degraded around: the breaker pins the op to the plain version of its
default backend (JAX's ``ref``) for the rest of its lifetime, records one
``FaultEvent("circuit-breaker", ...)`` per trip and re-runs the call
there. Any other exception propagates, breaker or not: a kernel that
fails to build or launch on the card is never hidden behind its plain
version (JAX's breaker acts at trace time on any error; the port's acts
at every call, kernels included, so it is narrower). JAX pins an (op,
shape bucket) cell; this policy has no shape buckets, so the port pins
the op: every shape of it.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Mapping, Optional, Set, Tuple, Union

import torch

from repro_torch.dist.fault import FaultEvent, InjectedFault

POLICIES = ("auto", "ref")


@dataclass(frozen=True)
class OpEntry:
    name: str
    plain: Callable
    kernel: Callable
    lossy: bool = False


_REGISTRY: Dict[str, OpEntry] = {}          # each op's default backend
_NAMED: Dict[Tuple[str, str], OpEntry] = {}  # (op, backend): the others
_BUILTINS = []          # set once the built-in ops modules are imported


def register(name: str, plain: Callable, kernel: Callable,
             backend: str = "default", lossy: bool = False) -> None:
    """Register op ``name``'s default backend, or a further ``backend``
    (its launches are counted as ``<op>_<backend>``)."""
    if backend == "default":
        _REGISTRY[name] = OpEntry(name, plain, kernel, lossy)
    else:
        _NAMED[(name, backend)] = OpEntry(name, plain, kernel, lossy)


def unregister(name: str, backend: str) -> None:
    """Drop op ``name``'s further ``backend`` (a default backend stays)."""
    if backend == "default":
        raise ValueError("an op's default backend cannot be unregistered")
    del _NAMED[(name, backend)]


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


PolicyLike = Union[str, Policy]


def call(op: str, policy: PolicyLike, *args, **kwargs):
    """Dispatch ``op`` to the backend ``policy`` names for it (the default
    unless a :class:`Policy` names another): its kernel for CUDA tensors
    under mode ``"auto"``, its plain version for CPU tensors or under
    ``"ref"``. With a :class:`CircuitBreaker` installed, an op it pinned
    runs the plain version of its default backend, and a backend that
    raises an ``InjectedFault`` trips the breaker and the call is re-run
    there; any other exception propagates."""
    if isinstance(policy, Policy):
        mode, backend = policy.mode, policy.backend_for(op)
    elif policy in POLICIES:
        mode, backend = policy, "default"
    else:
        raise ValueError(f"unknown policy {policy!r}; expected one of "
                         f"{POLICIES} or a Policy")
    e = entry(op, backend)
    device = next(a.device for a in args if isinstance(a, torch.Tensor))
    if mode == "ref" or device.type == "cpu":
        fn = e.plain
    else:
        if torch.is_grad_enabled() and any(
                isinstance(a, torch.Tensor) and a.requires_grad
                for a in args + tuple(kwargs.values())):
            raise RuntimeError(
                f"xaif: op {op!r} would launch its CUDA kernel on a tensor "
                f"that requires grad, and no kernel has a backward: the "
                f"gradient would stop here. Train under the 'ref' policy, "
                f"or run inference under torch.no_grad()")
        fn = e.kernel
    breaker = _BREAKER
    if breaker is None:
        return fn(*args, **kwargs)
    fallback = entry(op).plain
    if op in breaker.pinned or fn is fallback:
        return fallback(*args, **kwargs)
    try:
        return fn(*args, **kwargs)
    except InjectedFault as exc:     # degrade, counted and logged
        breaker.trip(op, backend, exc)
    return fallback(*args, **kwargs)


class CircuitBreaker:
    """Pins ops whose backend raised an ``InjectedFault`` inside
    :func:`call` to the plain version of their default backend (JAX's
    ``ref``).

    A trip is permanent for the breaker's lifetime: the failed backend is
    not retried mid-stream. Each trip adds one to ``trips`` and logs one
    :class:`FaultEvent` (kind ``"circuit-breaker"``) into ``events``,
    which may be shared with a ``FaultInjector`` so that one timeline holds
    the injected faults and the degradations they caused. ``pinned`` holds
    the pinned op names: the port's policy has no shape buckets (JAX pins
    one bucket of an op; the event says ``bucket=*``)."""

    def __init__(self, events: Optional[List[FaultEvent]] = None):
        self.pinned: Set[str] = set()
        self.events = events if events is not None else []
        self.trips = 0

    def trip(self, op: str, backend: str, exc: Exception) -> None:
        self.pinned.add(op)
        self.trips += 1
        self.events.append(FaultEvent(
            "circuit-breaker", self.trips,
            f"op={op} bucket=* backend={backend} -> plain: "
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
    """(counter name, kernel wrapper) of every backend. A default
    backend's counter is its op's name, another's ``<op>_<backend>``."""
    _ensure_builtin_ops()
    out = [(name, _REGISTRY[name].kernel) for name in sorted(_REGISTRY)]
    out += [(f"{op}_{b}", e.kernel) for (op, b), e in sorted(_NAMED.items())]
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
    for _, kernel in _counters():
        kernel.launches = 0
        for k in getattr(kernel, "instances", {}):
            kernel.instances[k] = 0
