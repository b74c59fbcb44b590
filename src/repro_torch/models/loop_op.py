"""A Python loop of identical steps that a trace counts as one operation.

xLSTM's two recurrences run as Python loops over time: the sLSTM one step
at a time, the mLSTM one chunk at a time.  The reference writes each as a
``lax.scan``, which XLA traces once and ``repro.launch.hlo_cost``
multiplies by its trip count.  :class:`LoopOp` is the port's counterpart:

* a real tensor (on the CPU or on CUDA, under any dispatch mode, in a
  CUDA-graph capture or not) runs the loop itself, so ``FlopCounterMode``
  over a real step counts every step;
* a fake or meta tensor, or a DTensor on a mesh of more than one rank,
  goes through a custom op ``repro_torch::<name>`` (and its backward op
  ``repro_torch::<name>_bwd`` under :class:`_LoopFunction`): a trace
  dispatches the same operations whatever the trip count;
* each op's cost is the loop's, counted by ``launch.op_cost.OpCost`` over
  the loop's first two steps and its first three on fake tensors of the
  same shapes: every step runs the same operations on operands of the
  same shapes, but for the first (whose carries may take no gradient) and
  the last (whose carries may give none), so n steps cost two and n - 2
  times what a third adds;
* the forward op returns a residual of the bytes the loop's autograd
  would keep for its backward beyond the operands, so a traced step's
  memory is a real step's; the real implementation leaves it unwritten
  and its backward runs the loop again under autograd;
* its sharding rule runs the loop on each rank's batch rows, with the
  operands named ``whole`` (weights) taken whole: one gather a call, and
  their gradients' partial sums reduced once a call, never once a step.
"""
from __future__ import annotations

import functools
import threading
import weakref
from typing import Callable, NamedTuple

import torch
from torch._subclasses.fake_tensor import is_fake
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from ..core.streams import is_dtensor
from ..kernels._cost import register_cost
from ..kernels._dtensor import local_operands, sharding_rule

__all__ = ["LoopCounts", "LoopOp"]


def _mask(flags) -> int:
    return sum(1 << i for i, f in enumerate(flags) if f)


@functools.lru_cache(maxsize=None)
def _fresh_key_sets() -> tuple:
    """The dispatch keys a new thread includes and excludes.  The loop
    is counted, and differentiated on real tensors, while an operation is
    being dispatched (below autograd, where autograd records nothing):
    under these keys autograd records it again."""
    sets = []
    t = threading.Thread(target=lambda: sets.append((
        torch._C._dispatch_tls_local_include_set(),
        torch._C._dispatch_tls_local_exclude_set())))
    t.start()
    t.join()
    return sets[0]


def _vjp(loop, args, statics, needs: int, grads):
    """The gradients of the operands in ``needs`` (a bitmask) of
    ``loop(*args, *statics)`` at ``grads`` (one per output, None: not
    given), by autograd through the loop run again."""
    with torch._C._ForceDispatchKeyGuard(*_fresh_key_sets()), \
            torch.enable_grad():
        ins = [a.detach().requires_grad_(bool(needs >> i & 1))
               for i, a in enumerate(args)]
        outs = loop(*ins, *statics)
        pairs = [(o, g) for o, g in zip(outs, grads) if g is not None]
        return torch.autograd.grad([o for o, _ in pairs],
                                   [a for a in ins if a.requires_grad],
                                   [g for _, g in pairs], allow_unused=True)


def _per_row(nbytes, t) -> int:
    """``nbytes`` as bytes a batch row of ``t`` (rounded up)."""
    return max(0, -(-int(nbytes) // t.shape[0]))


def _strides(grads) -> tuple:
    """Each output gradient's strides, or None where it has none."""
    return tuple(None if g is None else g.stride() for g in grads)


def _order(t) -> tuple:
    """``t``'s dims from the outermost in memory (the largest stride) in."""
    return tuple(sorted(range(t.ndim), key=lambda d: (-t.stride(d), d)))


def _strides_in(shape, order) -> list:
    """The strides of a dense tensor of ``shape`` laid out in ``order``."""
    strides, step = [0] * len(shape), 1
    for d in reversed(order):
        strides[d] = step
        step *= shape[d]
    return strides


def _spread(got, needs: int, n: int) -> list:
    """``got`` (the gradients of the operands in ``needs``) at the places
    of n operands, None elsewhere."""
    got = iter(got)
    return [next(got) if needs >> i & 1 else None for i in range(n)]


def _storages(tensors) -> dict:
    """The distinct storages under ``tensors``: id → bytes."""
    return {t.untyped_storage()._cdata: t.untyped_storage().nbytes()
            for t in tensors if isinstance(t, torch.Tensor)}


class _Live(TorchDispatchMode):
    """The bytes of the storages the operations under it make, while they
    live (``now``), and their most (``peak``); ``known`` tensors' storages
    are not counted."""

    def __init__(self, known=()):
        super().__init__()
        self.now = self.peak = 0
        self._seen = set(_storages(known))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten(out)[0]:
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            if st._cdata not in self._seen:
                self._seen.add(st._cdata)
                self.now += st.nbytes()
                self.peak = max(self.peak, self.now)
                weakref.finalize(st, self._free, st._cdata, st.nbytes())
        return out

    def _free(self, key, n) -> None:
        self.now -= n
        self._seen.discard(key)


class LoopCounts(NamedTuple):
    """What a loop costs, as ``OpCost`` counts it, and how its memory
    goes (bytes).  A transient is the most the loop holds for a while
    above what it holds at its end (in the backward: above the residual,
    the outputs and the gradients); ``kept`` is what autograd keeps
    beyond the operands and the outputs, ``unkept`` the operands it does
    not keep (which :class:`_LoopFunction` keeps), and the residual the
    difference."""
    fwd_flops: float
    fwd_bytes: float
    fwd_transient: float        # without autograd
    bwd_flops: float = 0.0
    bwd_bytes: float = 0.0
    kept: float = 0.0
    bwd_transient: float = 0.0
    unkept: float = 0.0
    grad_fwd_transient: float = 0.0   # the forward under autograd

    @property
    def residual(self) -> float:
        return self.kept - self.unkept


#: how :meth:`LoopOp.counts` takes each entry of n steps from two steps'
#: and three steps' (:meth:`LoopOp._counted`): FLOPs and bytes, forward
#: and backward, grow by a step at a time, and so do the bytes autograd
#: keeps; the transients are the larger of the two; the operands autograd
#: keeps are those three steps keep (an operand is kept once however many
#: steps read it)
_GROW, _MOST, _LAST = "grow", "most", "last"
_ENTRIES = LoopCounts(_GROW, _GROW, _MOST, _GROW, _GROW, _GROW, _MOST, _LAST,
                      _MOST)


class LoopOp:
    """``loop(*operands, *statics, steps=None)`` (``steps``: run only the
    first ``steps`` steps) as the custom ops ``repro_torch::<name>`` and
    ``repro_torch::<name>_bwd``.

    ``operands`` names the tensor operands (each with its batch first),
    ``statics`` the int arguments after them, ``whole`` the operands the
    sharding rule keeps whole (weights), ``outputs`` how many tensors the
    loop returns and ``fake(*operands, *statics)`` their (shape, dtype).
    ``trips(*operands, *statics)`` is the loop's step count.

    Besides the loop's outputs the forward op returns the residual and a
    workspace, and the backward op a workspace: uint8 tensors of a size a
    batch row, unwritten, that stand for the memory the loop keeps for its
    backward and the most it holds for a while (:meth:`counts`)."""

    def __init__(self, name: str, loop: Callable, operands: tuple,
                 outputs: int, fake: Callable, trips: Callable, *,
                 statics: tuple = (), whole: tuple = ()):
        self.name, self.loop, self.fake, self.trips = name, loop, fake, trips
        self.n_in, self.n_out = len(operands), outputs
        self.n_static = len(statics)
        # the ints are ``int``, not ``SymInt``: DTensor keys a registered
        # rule's cached result on ``int`` arguments only, and they change
        # the outputs' shapes
        ints = "".join(f", int {s}" for s in statics)
        tensors = ", ".join(f"Tensor {o}" for o in operands)
        op = torch.library.custom_op(
            f"repro_torch::{name}", self._forward, mutates_args=(),
            schema=f"({tensors}{ints}, int res_row, int ws_row) -> "
                   f"({', '.join(['Tensor'] * (outputs + 2))})")
        op.register_fake(self._forward_fake)
        grads = ", ".join(f"Tensor d{i}" for i in range(outputs))
        bwd = torch.library.custom_op(
            f"repro_torch::{name}_bwd", self._backward, mutates_args=(),
            schema=f"({grads}, {tensors}, Tensor res{ints}, int ws_row, "
                   f"int needs) -> "
                   f"({', '.join(['Tensor'] * (len(operands) + 1))})")
        bwd.register_fake(self._backward_fake)
        self.op = getattr(torch.ops.repro_torch, name)
        self.bwd = getattr(torch.ops.repro_torch, f"{name}_bwd")
        whole = {operands.index(w) for w in whole}
        sharding_rule(self.op.default)(functools.partial(self._rule, whole))
        sharding_rule(self.bwd.default)(functools.partial(self._bwd_rule,
                                                          whole))
        register_cost(self.op, self._cost)
        register_cost(self.bwd, self._bwd_cost)

    # -- routing ------------------------------------------------------------
    def __call__(self, *args):
        """The loop's outputs for ``operands`` and ``statics``."""
        tensors = local_operands(self.name, *args[:self.n_in])
        statics = tuple(args[self.n_in:])
        t = tensors[0]
        if not (is_dtensor(t) or is_fake(t) or t.device.type == "meta"):
            return self.loop(*tensors, *statics)
        if torch.is_grad_enabled() and any(a.requires_grad for a in tensors):
            return _LoopFunction.apply(self, statics, *tensors)
        ws = self.counts(tensors, statics).fwd_transient
        return self.op(*tensors, *statics, 0, _per_row(ws, t))[:-2]

    # -- the ops on real and on fake tensors ------------------------------
    def _rows(self, t, *rows):
        return tuple(t.new_empty((t.shape[0], r), dtype=torch.uint8)
                     for r in rows)

    def _forward(self, *args):
        *tensors, res_row, ws_row = args
        return (*self.loop(*tensors), *self._rows(tensors[0], res_row,
                                                   ws_row))

    def _forward_fake(self, *args):
        *tensors, res_row, ws_row = args
        t = tensors[0]
        orders = self._measured(tensors[:self.n_in], tensors[self.n_in:])[1]
        return (*(t.new_empty_strided(shape, _strides_in(shape, order),
                                      dtype=dtype)
                  for (shape, dtype), order in zip(self.fake(*tensors),
                                                   orders)),
                *self._rows(t, res_row, ws_row))

    def _split(self, args):
        """A backward op's arguments: (output gradients (None where not
        given), operands, statics, ws_row, needs)."""
        m, n = self.n_out, self.n_in
        grads = [g if g.numel() else None for g in args[:m]]
        statics = args[m + n + 1:m + n + 1 + self.n_static]
        return grads, args[m:m + n], statics, args[-2], args[-1]

    def _backward(self, *args):
        grads, tensors, statics, ws_row, needs = self._split(args)
        got = _spread(_vjp(self.loop, tensors, statics, needs, grads), needs,
                      self.n_in)
        return (*(a.new_empty(0) if not needs >> i & 1 else
                  torch.zeros_like(a) if g is None else g
                  for i, (a, g) in enumerate(zip(tensors, got))),
                *self._rows(tensors[0], ws_row))

    def _backward_fake(self, *args):
        grads, tensors, statics, ws_row, needs = self._split(args)
        orders = self._measured(tensors, statics, needs, _strides(grads))[2]
        return (*(a.new_empty_strided(a.shape, _strides_in(a.shape, order))
                  if needs >> i & 1 else a.new_empty(0)
                  for i, (a, order) in enumerate(zip(tensors, orders))),
                *self._rows(tensors[0], ws_row))

    # -- costs ------------------------------------------------------------
    def counts(self, tensors, statics, needs: int = 0,
               grads: tuple | None = None) -> LoopCounts:
        """The loop's :class:`LoopCounts` over all its steps; the backward's
        with ``needs`` (a bitmask of the operands that take a gradient),
        for the output gradients ``grads`` (each one's strides, or None
        where an output has none; default: the first output's, dense)."""
        return self._measured(tensors, statics, needs, grads)[0]

    def _measured(self, tensors, statics, needs: int = 0,
                  grads: tuple | None = None) -> tuple:
        """(:meth:`counts`, the dim order of each output, of each operand's
        gradient (None without ``needs``)): the layouts the loop leaves,
        which the fake ops give their outputs, so what reads them next
        copies what it copies after the loop."""
        t = tensors[0]
        dev = "cuda" if t.device.type == "cuda" \
            and torch.cuda.is_available() else "meta"
        sig = (dev, tuple((tuple(a.shape), a.stride(), a.dtype)
                          for a in tensors), tuple(statics))
        n = self.trips(*tensors, *statics)
        if n <= 2:
            return self._counted(sig, n, needs, grads)
        two = self._counted(sig, 2, needs, grads)
        three = self._counted(sig, 3, needs, grads)
        return (LoopCounts(*(a + (n - 2) * (b - a) if how == _GROW else
                             max(a, b) if how == _MOST else b
                             for how, a, b in zip(_ENTRIES, two[0],
                                                  three[0]))),
                *three[1:])

    @functools.lru_cache(maxsize=None)
    def _counted(self, sig: tuple, steps: int, needs: int,
                 grads: tuple | None) -> tuple:
        """:meth:`counts` of the first ``steps`` steps, on fake tensors of
        ``sig`` (the operands' shapes, strides and dtypes: a transposed
        operand makes a product copy it; on the meta device, or CUDA where
        the operands lie there: ``log_sigmoid_forward`` keeps a buffer on
        the CPU only), outside any mode or dispatch the caller is in."""
        from torch._subclasses.fake_tensor import FakeTensorMode
        from torch.utils._python_dispatch import _disable_current_modes

        from ..launch.op_cost import OpCost

        dev, shapes, statics = sig
        with _disable_current_modes(), \
                torch._C._ForceDispatchKeyGuard(*_fresh_key_sets()), \
                FakeTensorMode():
            ins = [torch.empty_strided(s, st, dtype=dt, device=dev)
                   for s, st, dt in shapes]
            live = _Live(ins)
            with torch.no_grad(), live, OpCost() as fwd:
                outs = self.loop(*ins, *statics, steps=steps)
            counts = (fwd.cost.flops, fwd.cost.bytes, live.peak - live.now)
            orders = tuple(_order(o) for o in outs)
            if not needs:
                return LoopCounts(*counts), orders, None
            given = [torch.empty_like(outs[0])] if grads is None else [
                None if st is None else torch.empty_strided(
                    o.shape, st, dtype=o.dtype, device=o.device)
                for o, st in zip(outs, grads)]
            del outs
            kept: dict = {}

            def pack(t):
                kept.update(_storages([t]))
                return t
            live = _Live([*ins, *(g for g in given if g is not None)])
            with torch.enable_grad(), live:
                leaves = [a.detach().requires_grad_(bool(needs >> i & 1))
                          for i, a in enumerate(ins)]
                with torch.autograd.graph.saved_tensors_hooks(pack,
                                                              lambda t: t):
                    outs = self.loop(*leaves, *statics, steps=steps)
                after, transient = live.now, live.peak - live.now
                unkept = sum(n for key, n in _storages(ins).items()
                             if key not in kept)
                kept_bytes = after - sum(_storages(outs).values())
                live.peak = after
                pairs = [(o, g) for o, g in zip(outs, given) if g is not None]
                with OpCost() as bwd:
                    got = torch.autograd.grad(
                        [o for o, _ in pairs],
                        [a for a in leaves if a.requires_grad],
                        [g for _, g in pairs], allow_unused=True)
                peak = live.peak - after - sum(_storages(
                    [g for g in got if g is not None]).values())
            grad_orders = tuple(_order(a) if g is None else _order(g)
                                for a, g in zip(ins, _spread(got, needs,
                                                             len(ins))))
        return (LoopCounts(*counts, bwd.cost.flops, bwd.cost.bytes,
                           kept_bytes, peak, unkept, transient), orders,
                grad_orders)

    def _cost(self, *args) -> tuple[int, int]:
        tensors = args[:self.n_in]
        got = self.counts(tensors, args[self.n_in:-2])
        return int(got.fwd_flops), int(got.fwd_bytes)

    def _bwd_cost(self, *args) -> tuple[int, int]:
        grads, tensors, statics, _, needs = self._split(args)
        got = self.counts(tensors, statics, needs, _strides(grads))
        return int(got.bwd_flops), int(got.bwd_bytes)

    # -- sharding -----------------------------------------------------------
    def _rule(self, whole, *args):
        """Independent over the batch: the operands but ``whole``, the
        outputs and the residual by their rows, ``whole`` taken whole;
        every step reads the last."""
        from torch.distributed.tensor import Replicate, Shard
        R, B = Replicate(), Shard(0)
        ins = [R if i in whole else B for i in range(self.n_in)]
        rest = [None] * (self.n_static + 2)
        return [([R] * (self.n_out + 2), [R] * self.n_in + rest),
                ([B] * (self.n_out + 2), ins + rest)]

    def _bwd_rule(self, whole, *args):
        """As the forward's, where the gradients of ``whole`` are each
        rank's partial sums (reduced once a call); an empty tensor (a
        gradient not given or not taken) is whole."""
        import math

        from torch.distributed.tensor import Partial, Replicate, Shard
        R, B, P = Replicate(), Shard(0), Partial()
        needs = args[-1]
        grads = [B if math.prod(g.shape) else R for g in args[:self.n_out]]
        ins = [R if i in whole else B for i in range(self.n_in)]
        outs = [(P if i in whole else B) if needs >> i & 1 else R
                for i in range(self.n_in)]
        rest = [None] * (self.n_static + 2)
        n = self.n_out + self.n_in + 1
        return [([R] * (self.n_in + 1), [R] * n + rest),
                (outs + [B], grads + ins + [B] + rest)]


class _LoopFunction(torch.autograd.Function):
    """A :class:`LoopOp`'s forward op with its backward op: the forward
    keeps the operands and the residual, so a traced step holds what a
    real one holds."""

    @staticmethod
    def forward(ctx, loop_op, statics, *tensors):
        ctx.loop_op, ctx.statics = loop_op, statics
        ctx.needs = _mask(ctx.needs_input_grad[2:])
        got = loop_op.counts(tensors, statics, ctx.needs)
        t = tensors[0]
        *outs, res, _ = loop_op.op(*tensors, *statics,
                                   _per_row(got.residual, t),
                                   _per_row(got.grad_fwd_transient, t))
        ctx.save_for_backward(*tensors, res)
        ctx.set_materialize_grads(False)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        saved = ctx.saved_tensors
        loop_op, t = ctx.loop_op, saved[0]
        ws = loop_op.counts(saved[:-1], ctx.statics, ctx.needs,
                            _strides(grads)).bwd_transient
        empty = t.new_empty(0)
        grads = [empty if g is None else g for g in grads]
        *got, _ = loop_op.bwd(*grads, *saved, *ctx.statics, _per_row(ws, t),
                              ctx.needs)
        return (None, None, *(g if ctx.needs_input_grad[2 + i] else None
                              for i, g in enumerate(got)))
