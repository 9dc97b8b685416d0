"""Loss scaling and fp8 delayed scaling (port of
``apex_tpu/amp/scaler.py``).

:class:`LossScaler` is Apex's dynamic loss scaler over a functional
state, :class:`LossScaleState`: int32 and fp32 0-dim tensors on the CPU
(the port's optimizer step counters live there too), so its arithmetic
never waits for the device. The reference decides the overflow skip on
the device (``lax.cond``); the port's flat Adam kernel updates its m and
v slabs in place, so the skip must be known before the update runs. The
port therefore reads the overflow flag on the host once a step, as CUDA
Apex does (``apex/amp/scaler.py`` ``update_scale``), and on overflow
does not call ``tx.update`` at all: params, state and step counter stay
as they were.

The fp8 tier (O4): :class:`Fp8DelayedScaler` owns amax rings for its
matmul sites (two E4M3 forward rows and one E5M2 gradient row each), and
``with fp8.step(state) as ctx:`` makes every
``ops.precision.matmul_amp`` call inside the block that names a
registered site an fp8 product under its delayed scales, recording this
step's amaxes. Sites are identified by (name, call ordinal); a site the
scaler was not built with takes the product it runs outside the context
(``matmul_amp``'s: ``torch.matmul``, or the fp32 accumulator for
``keep_acc``), the same bits inside and out. Gradients
go through ``ctx.value_and_grad``: the E5M2 amaxes come back as the
gradients of per-site zero probes (one fp32 leaf tensor of one element a
site, whose element ``i`` each site's ``grad_probe`` is).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from apex_tpu_torch import _device
from apex_tpu_torch.amp.frontend import map_tree
from apex_tpu_torch.observability.numerics.history import (
    F8_E4M3_MAX,
    F8_E5M2_MAX,
    AmaxHistory,
)


def _vote(x: torch.Tensor, axes, op) -> torch.Tensor:
    """``x`` reduced with ``op`` over the process groups bound to
    ``axes`` (``apex_tpu_torch.distributed``), the reference's
    psum/pmax over mesh axes; ``x`` as it is when ``axes`` is empty."""
    if not axes:
        return x
    from apex_tpu_torch.distributed import backend

    return backend.all_reduce(x, getattr(backend.ReduceOp, op),
                              tuple(axes))


def _flat(tree) -> list:
    """The tensors of a tree of dicts, lists and tuples, in the order
    :func:`~apex_tpu_torch.amp.frontend.map_tree` visits them."""
    out = []
    map_tree(out.append, tree)
    return out


def _like(tree, values):
    """``tree`` with its tensors replaced by ``values``, in order."""
    it = iter(values)
    return map_tree(lambda _: next(it), tree)


class LossScaleState(NamedTuple):
    """Loss-scaler state, 0-dim tensors on the CPU (``scaler.py:42``):
    ``steps``, ``last_overflow_step`` and ``skip_streak`` say when the
    last overflow hit and how many steps in a row were skipped."""

    loss_scale: torch.Tensor          # fp32
    unskipped: torch.Tensor           # int32: clean steps since a rescale
    overflows: torch.Tensor           # int32: overflows in all
    steps: torch.Tensor               # int32: update() calls
    last_overflow_step: torch.Tensor  # int32: newest overflow (-1 = never)
    skip_streak: torch.Tensor         # int32: overflow skips in a row


def _i32(v) -> torch.Tensor:
    return torch.tensor(int(v), dtype=torch.int32)


class LossScaler:
    """Static and dynamic loss scaling (``scaler.py:59``). ``dynamic``
    starts at 2**16, doubles every ``scale_window`` clean steps (at most
    ``max_loss_scale``) and halves on overflow (at least
    ``min_loss_scale`` when given)."""

    def __init__(self, loss_scale="dynamic", init_scale=2.0 ** 16,
                 scale_factor=2.0, scale_window=2000, min_loss_scale=None,
                 max_loss_scale=2.0 ** 24, enabled=True,
                 backoff_factor=None):
        self.dynamic = loss_scale == "dynamic"
        self._static_scale = 1.0 if self.dynamic else float(loss_scale)
        self.init_scale = init_scale if self.dynamic else self._static_scale
        self.scale_factor = scale_factor
        self.backoff_factor = (1.0 / scale_factor if backoff_factor is None
                               else backoff_factor)
        self.scale_window = scale_window
        self.min_loss_scale = min_loss_scale
        self.max_loss_scale = max_loss_scale
        self.enabled = enabled

    def init(self) -> LossScaleState:
        return LossScaleState(
            loss_scale=torch.tensor(
                self.init_scale if self.enabled else 1.0,
                dtype=torch.float32),
            unskipped=_i32(0), overflows=_i32(0), steps=_i32(0),
            last_overflow_step=_i32(-1), skip_streak=_i32(0))

    def scale_loss(self, loss, state: LossScaleState):
        """``loss * loss_scale`` (in the loss's dtype) before the
        backward."""
        if not self.enabled:
            return loss
        return loss * state.loss_scale.to(loss.dtype)

    def unscale(self, grads, state: LossScaleState):
        """``(unscaled grads, overflow)``: each leaf ``(g.float() * (1 /
        loss_scale)).to(g.dtype)``, and a 0-dim bool tensor on the grads'
        device that is True when any unscaled value is inf or nan."""
        if not self.enabled:
            return grads, torch.zeros((), dtype=torch.bool)
        inv = torch.ones((), dtype=torch.float32) / state.loss_scale
        leaves = [(g.float() * inv).to(g.dtype) for g in _flat(grads)]
        if not leaves:
            return grads, torch.zeros((), dtype=torch.bool)
        finite = torch.stack([torch.isfinite(g).all() for g in leaves])
        return _like(grads, leaves), ~finite.all()

    def update(self, state: LossScaleState, overflow) -> LossScaleState:
        """The dynamic-scale automaton (``scaler.py:119``). ``overflow``
        is read on the host. The diagnostic fields advance for any enabled
        scaler, the scale itself only for a dynamic one."""
        if not self.enabled:
            return state
        ovf = bool(overflow)
        diag = dict(
            overflows=state.overflows + int(ovf), steps=state.steps + 1,
            last_overflow_step=(state.steps.clone() if ovf
                                else state.last_overflow_step.clone()),
            skip_streak=state.skip_streak + 1 if ovf else _i32(0))
        if not self.dynamic:
            return state._replace(**diag)
        grow = int(state.unskipped) + 1 >= self.scale_window
        if ovf:
            scale = state.loss_scale * self.backoff_factor
            if self.min_loss_scale is not None:  # no floor by default
                scale = torch.clamp(scale, min=self.min_loss_scale)
        elif grow:
            scale = torch.clamp(state.loss_scale * self.scale_factor,
                                max=self.max_loss_scale)
        else:
            scale = state.loss_scale.clone()
        unskipped = _i32(0) if (ovf or grow) else state.unskipped + 1
        return state._replace(loss_scale=scale, unskipped=unskipped, **diag)

    def loss_scale(self, state: LossScaleState):
        return state.loss_scale

    def overflow_count(self, state: LossScaleState) -> int:
        """The overflows so far, as a host int."""
        return int(state.overflows)

    def report(self, state: LossScaleState, registry=None, prefix="amp",
               grads=None, top_k: int = 3) -> dict:
        """Publish scaler health to a metrics registry (``scaler.py:180``;
        default: the process registry): gauges ``<prefix>/loss_scale``,
        ``<prefix>/overflow_count``, ``<prefix>/unskipped_steps``,
        ``<prefix>/last_overflow_step`` and ``<prefix>/skip_streak``, the
        fields the numerics ``HealthMonitor``'s overflow-streak detector
        consumes. Returns the values as a dict. One host read a call (the
        state's counters are CPU tensors, read together).

        ``grads``: pass the (scaled) grads tree when the last update
        overflowed and the readout should say WHICH tensors blew up - one
        stats pass names the top-``top_k`` tensors by amax (+ any
        non-finite paths) in an ``amp_overflow`` event and a
        ``top_offenders`` key. Skipped on clean steps."""
        from apex_tpu_torch.observability import get_registry, numerics

        host = torch.stack([state.loss_scale.double(),
                            state.overflows.double(),
                            state.unskipped.double(),
                            state.last_overflow_step.double(),
                            state.skip_streak.double()]).tolist()
        values = {
            "loss_scale": float(host[0]),
            "overflow_count": int(host[1]),
            "unskipped_steps": int(host[2]),
            "last_overflow_step": int(host[3]),
            "skip_streak": int(host[4]),
        }
        reg = registry if registry is not None else get_registry()
        for name, v in values.items():
            reg.gauge(f"{prefix}/{name}").set(v)
        if grads is not None and values["skip_streak"] > 0:
            per_tensor = numerics.host_tensor_stats(grads)
            summary = numerics.summarize_stats(per_tensor, top_k=top_k)
            values["top_offenders"] = summary["worst_amax"]
            reg.event("amp_overflow", prefix=prefix,
                      step=values["last_overflow_step"],
                      skip_streak=values["skip_streak"],
                      loss_scale=values["loss_scale"],
                      top_offenders=summary["worst_amax"],
                      nonfinite_paths=summary["nonfinite_paths"])
        return values

    def state_dict(self, state: LossScaleState) -> dict:
        """Python numbers, the reference's format: a dict either package
        wrote loads into the other."""
        return {"loss_scale": float(state.loss_scale),
                "unskipped": int(state.unskipped),
                "overflows": int(state.overflows),
                "steps": int(state.steps),
                "last_overflow_step": int(state.last_overflow_step),
                "skip_streak": int(state.skip_streak)}

    def load_state_dict(self, d: dict) -> LossScaleState:
        """Every field but ``loss_scale`` defaults (older dicts load as
        "never overflowed"); unknown keys (an O4 ``"fp8"`` block) are
        ignored."""
        return LossScaleState(
            loss_scale=torch.tensor(float(d["loss_scale"]),
                                    dtype=torch.float32),
            unskipped=_i32(d.get("unskipped", 0)),
            overflows=_i32(d.get("overflows", 0)),
            steps=_i32(d.get("steps", 0)),
            last_overflow_step=_i32(d.get("last_overflow_step", -1)),
            skip_streak=_i32(d.get("skip_streak", 0)))


# --------------------------------------------------------------- fp8 (O4)


class Fp8ScalingState(NamedTuple):
    """Delayed-scaling state (``scaler.py:277``)."""

    fwd: Any            # AmaxHistoryState over <site>/a, <site>/b (E4M3)
    grad: Any           # AmaxHistoryState over <site>/g (E5M2)
    steps: torch.Tensor  # int32 0-dim on the CPU: update() calls


_FP8_STACK: list = []


def current_fp8():
    """The innermost active fp8 context (``Fp8DelayedScaler.step`` or an
    :class:`Fp8SiteRecorder`), or None: what ``matmul_amp`` consults."""
    return _FP8_STACK[-1] if _FP8_STACK else None


class _Fp8ContextBase:
    def __enter__(self):
        _FP8_STACK.append(self)
        return self

    def __exit__(self, *exc):
        if _FP8_STACK and _FP8_STACK[-1] is self:
            _FP8_STACK.pop()
        return False

    def _site(self, name: str) -> str:
        k = self._counts.get(name, 0)
        self._counts[name] = k + 1
        return f"{name}#{k}"


def _outside_product(a, b, out_dtype):
    """The product of a site that runs no fp8 (``scaler.py:312``): the one
    ``matmul_amp`` runs outside the context, so that an unregistered site
    computes the same bits inside it and out, as the reference's do:
    ``torch.matmul`` in the operands' dtype, or, for an accumulator
    ``out_dtype`` (``keep_acc``), the fp32 accumulator."""
    from apex_tpu_torch.ops.precision import matmul_fp32acc

    out = torch.promote_types(a.dtype, b.dtype)
    if out_dtype is None or out_dtype == out:
        return torch.matmul(a, b)
    return matmul_fp32acc(a, b, keep_acc=True).to(out_dtype)


class Fp8SiteRecorder(_Fp8ContextBase):
    """Discovery context: records each fp8-eligible call site's name in
    call order while computing the product the site runs outside. Feed
    ``rec.sites`` to :class:`Fp8DelayedScaler`."""

    def __init__(self):
        self.sites = []
        self._counts = {}

    def matmul(self, a, b, name="matmul", out_dtype=None):
        self._site(name)
        self.sites.append(name)
        return _outside_product(a, b, out_dtype)


class _Fp8Apply(_Fp8ContextBase):
    """The live O4 context of one step (``scaler.py:336``): resolves each
    site's delayed scales from the state, runs registered sites through
    ``ops.precision.matmul_fp8_stats`` and collects the step's amaxes for
    :meth:`Fp8DelayedScaler.update`.

    Take gradients with :meth:`value_and_grad`. A registered site's
    name met again while its backward runs is a recompute (a
    ``torch.utils.checkpoint`` region); its ordinal cannot be known, and
    falling back would recompute other values than the forward saved, so
    it raises. Register only sites outside recomputed regions (the llama
    ``lm_head`` is outside ``run_layers``); unregistered names recompute
    their fallback product unchanged."""

    def __init__(self, scaler: "Fp8DelayedScaler", state: Fp8ScalingState):
        self.scaler = scaler
        self.state = state
        self._counts = {}
        self._fwd_scales, self._grad_scales = scaler.scales(state)
        self._fwd_amax = {}     # fwd row -> 0-dim fp32 amax
        self._probes = None     # fp32 [ng] leaf inside value_and_grad
        self._backward = False  # True while value_and_grad's backward runs
        self._harvest = None    # (fwd fp32 [nf], grad fp32 [ng])
        self.skipped_sites = []  # sites that fell back (unregistered)

    def matmul(self, a, b, name="matmul", out_dtype=None):
        from apex_tpu_torch.ops import precision as _prec

        if self._backward and name in self.scaler.names:
            raise RuntimeError(
                f"fp8 site {name!r} was called again during the backward: "
                f"a recomputed (checkpointed) region cannot keep its "
                f"ordinal; register only sites outside recomputed regions")
        site = self._site(name)
        fwd, grad = self.scaler.fwd_history, self.scaler.grad_history
        if f"{site}/a" not in fwd.paths:
            self.skipped_sites.append(site)
            return _outside_product(a, b, out_dtype)
        ia, ib = fwd.index(f"{site}/a"), fwd.index(f"{site}/b")
        ig = grad.index(f"{site}/g")
        y, amax_a, amax_b = _prec.matmul_fp8_stats(
            a, b, self._fwd_scales[ia], self._fwd_scales[ib],
            grad_scale=self._grad_scales[ig], out_dtype=out_dtype,
            grad_probe=None if self._probes is None else self._probes[ig])
        self._fwd_amax[ia] = amax_a
        self._fwd_amax[ib] = amax_b
        return y

    def _device(self):
        return self.state.fwd.ring.device

    def _stack_fwd(self):
        zero = torch.zeros((), dtype=torch.float32, device=self._device())
        return torch.stack([
            self._fwd_amax.get(i, zero).detach().to(self._device())
            for i in range(len(self.scaler.fwd_history.paths))])

    def value_and_grad(self, fn, argnums=0, has_aux=False):
        """``jax.value_and_grad``'s form over torch autograd: ``call(*args)
        -> (loss, grads)`` (``((loss, aux), grads)`` with ``has_aux``),
        the grads of the tensors of ``args[argnums]`` in their tree's
        shape, the loss detached. Call it inside the context, on the loss
        whose matmuls go through this context's sites."""
        scalar = isinstance(argnums, int)
        nums = (argnums,) if scalar else tuple(argnums)
        ng = len(self.scaler.grad_history.paths)

        def call(*args, **kwargs):
            args = list(args)
            for n in nums:
                args[n] = map_tree(lambda t: t.detach().requires_grad_(),
                                   args[n])
            probes = torch.zeros((ng,), dtype=torch.float32,
                                 device=self._device(), requires_grad=True)
            # fresh ordinals for this traversal: an eval forward before it
            # (or an earlier call, in grad accumulation) must not move a
            # registered site to name#1
            self._probes, self._counts, self._fwd_amax = probes, {}, {}
            try:
                out = fn(*args, **kwargs)
            finally:
                self._probes = None
            loss, aux = out if has_aux else (out, None)
            fwd = self._stack_fwd()
            self._fwd_amax = {}
            inputs = [probes] + [t for n in nums for t in _flat(args[n])]
            self._backward = True
            try:
                grads = torch.autograd.grad(loss, inputs,
                                            materialize_grads=True)
            finally:
                self._backward = False
            # the step's observation is the max over every traversal
            if self._harvest is None:
                self._harvest = (fwd, grads[0].detach())
            else:
                self._harvest = (torch.maximum(self._harvest[0], fwd),
                                 torch.maximum(self._harvest[1], grads[0]))
            self._counts = {}
            rest, user = list(grads[1:]), []
            for n in nums:
                k = len(_flat(args[n]))
                user.append(_like(args[n], rest[:k]))
                rest = rest[k:]
            user = user[0] if scalar else tuple(user)
            loss = loss.detach()
            return ((loss, aux) if has_aux else loss), user

        return call

    def fwd_amax(self):
        """This step's stacked E4M3 amaxes (fp32 ``[nf]``); rows not
        observed write 0, which never votes in the ring max."""
        if self._harvest is not None:
            return self._harvest[0]
        return self._stack_fwd()

    def grad_amax(self):
        """The stacked E5M2 cotangent amaxes (fp32 ``[ng]``), the probe
        gradients :meth:`value_and_grad` took; 0 with no backward."""
        if self._harvest is not None:
            return self._harvest[1]
        return torch.zeros((len(self.scaler.grad_history.paths),),
                           dtype=torch.float32, device=self._device())


class Fp8DelayedScaler:
    """Per-tensor delayed scaling for the O4 tier (``scaler.py:483``).

    ``sites``: ordered matmul-site names (duplicates become ``name#0``,
    ``name#1``, ... in call order), each owning two E4M3 forward rows and
    one E5M2 gradient row. The object is static configuration; the state
    is :class:`Fp8ScalingState`::

        with fp8.step(state) as ctx:
            loss, grads = ctx.value_and_grad(loss_fn)(params)
        state = fp8.update(state, ctx)
    """

    def __init__(self, sites, history: int = 16, margin: float = 0.0):
        counts: dict = {}
        canon = []
        for s in sites:
            k = counts.get(s, 0)
            counts[s] = k + 1
            canon.append(f"{s}#{k}")
        if not canon:
            raise ValueError("Fp8DelayedScaler needs at least one site")
        self.sites = tuple(canon)
        self.names = frozenset(counts)
        self.history = int(history)
        self.margin = float(margin)
        self.fwd_history = AmaxHistory(
            [f"{c}/{op}" for c in canon for op in ("a", "b")],
            length=history)
        self.grad_history = AmaxHistory([f"{c}/g" for c in canon],
                                        length=history)

    @classmethod
    def for_step(cls, fn, *example_args, history: int = 16,
                 margin: float = 0.0) -> "Fp8DelayedScaler":
        """A scaler for ``fn``'s sites, found by running ``fn`` once
        under :class:`Fp8SiteRecorder` (PyTorch has no abstract
        evaluation like ``jax.eval_shape``: the products run). A Python
        loop over layers records each layer's sites, where the
        reference's ``lax.scan`` body records once: prefer explicit
        sites for layered models."""
        with Fp8SiteRecorder() as rec:
            fn(*example_args)
        return cls(rec.sites, history=history, margin=margin)

    def init(self, device: _device.DeviceLike = None) -> Fp8ScalingState:
        """Empty rings on ``device`` (default: the GPU, raising when there
        is none)."""
        device = _device.resolve(device)
        return Fp8ScalingState(fwd=self.fwd_history.init(device),
                               grad=self.grad_history.init(device),
                               steps=torch.zeros((), dtype=torch.int32))

    def scales(self, state: Fp8ScalingState):
        """(fwd scales fp32 ``[2 * n_sites]``, grad scales fp32
        ``[n_sites]``) from the rings' maxima; rows with no signal yet
        scale by 1."""
        return (self.fwd_history.scales(state.fwd, fp8_max=F8_E4M3_MAX,
                                        margin=self.margin),
                self.grad_history.scales(state.grad, fp8_max=F8_E5M2_MAX,
                                         margin=self.margin))

    def step(self, state: Fp8ScalingState) -> _Fp8Apply:
        return _Fp8Apply(self, state)

    def update(self, state: Fp8ScalingState, ctx: _Fp8Apply,
               reduce_axes=()) -> Fp8ScalingState:
        """Write this step's amaxes into the rings (one column each).
        With ``reduce_axes`` (the names of process groups) every
        observation is max-reduced over them first, so that every rank
        writes the same column and the delayed scales stay replicated
        (``scaler.py:556``)."""
        return Fp8ScalingState(
            fwd=self.fwd_history.update(
                state.fwd, _vote(ctx.fwd_amax(), reduce_axes, "MAX")),
            grad=self.grad_history.update(
                state.grad, _vote(ctx.grad_amax(), reduce_axes, "MAX")),
            steps=state.steps + 1)

    def state_dict(self, state: Fp8ScalingState) -> dict:
        return {"sites": list(self.sites), "history": self.history,
                "margin": self.margin,
                "fwd": self.fwd_history.state_dict(state.fwd),
                "grad": self.grad_history.state_dict(state.grad),
                "steps": int(state.steps)}

    def load_state_dict(self, d: dict, device: _device.DeviceLike = None
                        ) -> Fp8ScalingState:
        if tuple(d.get("sites", ())) != self.sites:
            raise ValueError(
                "fp8 scaling state was recorded for a different site set "
                f"({list(d.get('sites', ()))} vs {list(self.sites)}); "
                "refusing to misalign the amax rings")
        device = _device.resolve(device)
        return Fp8ScalingState(
            fwd=self.fwd_history.load_state_dict(d["fwd"], device),
            grad=self.grad_history.load_state_dict(d["grad"], device),
            steps=_i32(d.get("steps", 0)))


def scaled_update(tx, scaler: LossScaler, grads, opt_state, params,
                  scaler_state, overflow_reduce_axes=()):
    """One amp step (``scaler.py:602``): unscale, check for overflow,
    then the optimizer update unless it overflowed. The overflow flag is
    read on the host; on overflow ``tx.update`` is not called, the
    updates are zeros in each param's dtype (the port's transforms return
    updates in the params' dtypes) and ``opt_state`` is returned as it
    was. With ``overflow_reduce_axes`` (the names of process groups) the
    flag is summed over them, so that every rank skips the step if any
    rank overflowed (``scaler.py:603-623``). Returns ``(updates,
    opt_state, scaler_state, overflow)``, the overflow a 0-dim bool
    tensor on the CPU."""
    unscaled, overflow = scaler.unscale(grads, scaler_state)
    if overflow_reduce_axes:
        device = next((g.device for g in _flat(grads)), overflow.device)
        overflow = _vote(overflow.to(device, torch.float32),
                         overflow_reduce_axes, "SUM") > 0
    overflow = torch.tensor(bool(overflow))
    if overflow:
        updates = map_tree(torch.zeros_like, params)
    else:
        with torch.no_grad():
            updates, opt_state = tx.update(unscaled, opt_state, params)
    return updates, opt_state, scaler.update(scaler_state, overflow), overflow
