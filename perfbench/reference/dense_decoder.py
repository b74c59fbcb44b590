"""The plain reference of a dense pre-norm decoder (phi3-mini-3.8b,
minicpm-2b): plain PyTorch in float32 with TF32 off, no kernel, no
cache, no batching; and the benchmark's draw of its weights.

The weights are the benchmark's, drawn here from the seed and handed to
the program and to this reference alike, in one tree: ``embed`` (V, d),
``final_norm`` (d,), ``lm_head`` (d, V) unless the head is tied to the
embedding, and ``groups[0]["sub0"]`` with each layer's weights stacked
along a leading axis of ``n_layers``: ``norm1``, ``norm2`` (L, d);
``mixer`` ``wq`` (L, d, H·hd), ``wk``, ``wv`` (L, d, K·hd), ``wo`` (L,
H·hd, d); ``ffn`` ``w_gate``, ``w_up`` (L, d, f), ``w_down`` (L, f, d).
A weight is applied as ``x @ W``.  A norm's weight is stored as its
offset from one (w = 1 + s, drawn as s = 0).

The layer, as the configuration states it:

    h = x + Attn(RMSNorm(x))          RoPE (split halves), causal, 1/√hd
    y = h + W_down(silu(W_gate n) ⊙ W_up n),   n = RMSNorm(h)
    logits = RMSNorm(y_L) @ head

Departures from the published models are the configuration file's
(``reduced``), not this file's.

``mode="fp8"`` is the control: every product takes its operands rounded
to float8 e4m3 and sums in f32 — the weight products (the projections,
the FFN and the head: activations scaled per row, weights per output
column) and attention's (q and k per row, the probabilities per row, v
per column), each scale taking the slice's largest magnitude to the
format's largest finite value; in training the gradients flow back
through the same rounded operands in f32.  It is
never the program's path: the comparison that decides ``correct`` must
find it wrong.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

FP8 = torch.float8_e4m3fn
FP8_MAX = 448.0

#: the matmul leaves of a layer, by sub-tree
MIXER = ("wq", "wk", "wv", "wo")
FFN = ("w_gate", "w_up", "w_down")


def sub_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for stream ``stream`` of run seed ``seed`` (any
    whole number, negative ones too)."""
    ss = np.random.SeedSequence([seed % (1 << 64), stream])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def leaf_specs(c: dict) -> list[tuple[tuple, tuple, float | None]]:
    """(path, shape, scale) of every weight, in drawing order: a scale
    draws normal weights times it; None makes zeros (a norm's offset)."""
    d, V, L = c["d_model"], c["vocab_size"], c["n_layers"]
    H, K, hd, f = c["n_heads"], c["n_kv_heads"], c["head_dim"], c["d_ff"]
    g = ("groups", 0, "sub0")
    specs = [(("embed",), (V, d), 0.02), (("final_norm",), (d,), None)]
    if not c["tie_embeddings"]:
        specs.append((("lm_head",), (d, V), 1 / math.sqrt(d)))
    specs += [
        (g + ("norm1",), (L, d), None),
        (g + ("mixer", "wq"), (L, d, H * hd), 1 / math.sqrt(d)),
        (g + ("mixer", "wk"), (L, d, K * hd), 1 / math.sqrt(d)),
        (g + ("mixer", "wv"), (L, d, K * hd), 1 / math.sqrt(d)),
        (g + ("mixer", "wo"), (L, H * hd, d), 1 / math.sqrt(H * hd)),
        (g + ("norm2",), (L, d), None),
        (g + ("ffn", "w_gate"), (L, d, f), 1 / math.sqrt(d)),
        (g + ("ffn", "w_up"), (L, d, f), 1 / math.sqrt(d)),
        (g + ("ffn", "w_down"), (L, f, d), 1 / math.sqrt(f)),
    ]
    return specs


def draw_leaf(shape, scale, stream_seed: int, device, dtype) -> torch.Tensor:
    """One weight from its own generator on ``device``: one normal draw
    in f32, scaled, cast to ``dtype``; zeros where ``scale`` is None."""
    if scale is None:
        return torch.zeros(shape, dtype=dtype, device=device)
    gen = torch.Generator(device=device).manual_seed(stream_seed)
    w = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return w.mul_(scale).to(dtype)


def _put(tree: dict, path: tuple, value) -> None:
    node = tree
    for key, nxt in zip(path[:-1], path[1:]):
        if isinstance(node, list):
            while len(node) <= key:
                node.append({})
        elif key not in node:
            node[key] = [] if isinstance(nxt, int) else {}
        node = node[key]
    node[path[-1]] = value


def get(tree, path: tuple):
    for key in path:
        tree = tree[key]
    return tree


def draw_params(c: dict, seed: int, device, *, matmul_dtype,
                norm_dtype=torch.float32) -> dict:
    """The benchmark's weights for run seed ``seed``: each leaf from its
    own stream, matmul weights in ``matmul_dtype``, norm offsets in
    ``norm_dtype``."""
    tree: dict = {}
    for i, (path, shape, scale) in enumerate(leaf_specs(c)):
        dt = norm_dtype if scale is None else matmul_dtype
        _put(tree, path, draw_leaf(shape, scale, sub_seed(seed, i), device,
                                   dt))
    return tree


def redraw(c: dict, seed: int, index: int, device) -> torch.Tensor:
    """Leaf ``index`` of :func:`draw_params` again, in f32."""
    path, shape, scale = leaf_specs(c)[index]
    return draw_leaf(shape, scale, sub_seed(seed, index), device,
                     torch.float32)


# ---------------------------------------------------------------------------
# the forward pass
# ---------------------------------------------------------------------------
def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to e4m3 with one scale per slice along ``dim`` (the
    largest magnitude to the format's largest value), back in f32."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12)
    s = FP8_MAX / amax
    return (x * s).to(FP8).float() / s


class _Fp8MatMul(torch.autograd.Function):
    """y = q(x) @ q(W): rows of x and columns of W each on their own
    e4m3 scale; the backward through the rounded operands in f32."""

    @staticmethod
    def forward(ctx, x, w):
        xq, wq = _fp8(x, -1), _fp8(w, 0)
        ctx.save_for_backward(xq, wq)
        return xq @ wq

    @staticmethod
    def backward(ctx, dy):
        xq, wq = ctx.saved_tensors
        dx = dy @ wq.T
        dw = (xq.reshape(-1, xq.shape[-1]).T
              @ dy.reshape(-1, dy.shape[-1]))
        return dx, dw


def _ste_fp8(x, dim: int, mode: str):
    """``x`` rounded as :func:`_fp8` in the forward pass where ``mode`` is
    fp8, its gradient passed through unchanged; ``x`` otherwise."""
    if mode != "fp8":
        return x
    return x + (_fp8(x.detach(), dim) - x).detach()


def _mm(x, w, mode: str):
    w = w.float()
    if mode == "fp8":
        return _Fp8MatMul.apply(x, w)
    return x @ w


def rms_norm(x, s, eps: float):
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return x * torch.rsqrt(var + eps) * (1.0 + s.float())


def rope(x, positions, theta: float):
    """Rotate x (..., S, H, D) by the S positions: the two halves of the
    head dim pair up."""
    D = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, D, 2, dtype=torch.float32,
                                        device=x.device) / D))
    ang = positions[:, None].float() * inv                 # (S, D/2)
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :D // 2], x[..., D // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _attention(q, k, v, head_block: int, mode: str = "f32"):
    """Causal softmax attention, (B, S, H, D) with K kv heads, in blocks
    of query heads so that the (S, S) scores of all heads never live at
    once."""
    B, S, H, D = q.shape
    K = k.shape[2]
    k = k.repeat_interleave(H // K, dim=2)
    v = v.repeat_interleave(H // K, dim=2)
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    outs = []
    for h0 in range(0, H, head_block):
        qs, ks, vs = (t[:, :, h0:h0 + head_block].transpose(1, 2)
                      for t in (q, k, v))
        s = (_ste_fp8(qs, -1, mode) @ _ste_fp8(ks, -1, mode).transpose(-1, -2)
             ) / math.sqrt(D)
        s = s.masked_fill(~mask, float("-inf"))
        p = _ste_fp8(torch.softmax(s, dim=-1), -1, mode)
        outs.append((p @ _ste_fp8(vs, -2, mode)).transpose(1, 2))
    return torch.cat(outs, dim=2)


def block(c: dict, lw: dict, x, positions, mode: str, head_block: int):
    """One layer on x (B, S, d) with its weights ``lw``."""
    B, S, d = x.shape
    H, K, hd = c["n_heads"], c["n_kv_heads"], c["head_dim"]
    n = rms_norm(x, lw["norm1"], c["norm_eps"])
    q = _mm(n, lw["wq"], mode).reshape(B, S, H, hd)
    k = _mm(n, lw["wk"], mode).reshape(B, S, K, hd)
    v = _mm(n, lw["wv"], mode).reshape(B, S, K, hd)
    theta = c["rope_theta"]
    q, k = rope(q, positions, theta), rope(k, positions, theta)
    a = _attention(q, k, v, head_block, mode).reshape(B, S, H * hd)
    h = x + _mm(a, lw["wo"], mode)
    n = rms_norm(h, lw["norm2"], c["norm_eps"])
    u = F.silu(_mm(n, lw["w_gate"], mode)) * _mm(n, lw["w_up"], mode)
    return h + _mm(u, lw["w_down"], mode)


def layers(params: dict) -> list[dict]:
    """Each layer's weights: one ``unbind`` per stacked leaf (a view per
    layer; under autograd one stacked gradient per leaf)."""
    g = params["groups"][0]["sub0"]
    flat = {"norm1": g["norm1"], "norm2": g["norm2"],
            **{k: g["mixer"][k] for k in MIXER},
            **{k: g["ffn"][k] for k in FFN}}
    per = {k: v.unbind(0) for k, v in flat.items()}
    return [{k: per[k][i] for k in per} for i in range(len(per["norm1"]))]


def head_weight(c: dict, params: dict):
    return params["embed"].T if c["tie_embeddings"] else params["lm_head"]


def hidden(c: dict, params: dict, tokens, *, mode: str = "f32",
           remat: bool = False, head_block: int = 8):
    """The final normed hidden states (B, S, d) in f32 for ``tokens``
    (B, S), layer by layer; ``remat`` recomputes each layer in the
    backward (memory for training at full size)."""
    x = params["embed"][tokens].float()
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    for lw in layers(params):
        if remat:
            x = checkpoint(block, c, lw, x, positions, mode, head_block,
                           use_reentrant=False)
        else:
            x = block(c, lw, x, positions, mode, head_block)
    return rms_norm(x, params["final_norm"], c["norm_eps"])


@torch.no_grad()
def logits(c: dict, params: dict, tokens, *, mode: str = "f32"):
    """(S, V) f32 logits of one sequence ``tokens`` (S,)."""
    with f32_matmuls():
        x = hidden(c, params, tokens[None], mode=mode)[0]
        return _mm(x, head_weight(c, params), mode)


def loss(c: dict, params: dict, tokens, labels, *, mode: str = "f32"):
    """Mean next-token cross entropy over the labels that are >= 0."""
    x = hidden(c, params, tokens, mode=mode, remat=True)
    lg = _mm(x, head_weight(c, params), mode)
    mask = labels >= 0
    nll = F.cross_entropy(lg.flatten(0, 1), labels.clamp(min=0).flatten(),
                          reduction="none").reshape(labels.shape)
    return torch.where(mask, nll, 0.0).sum() / mask.sum().clamp(min=1)


class f32_matmuls:
    """A context in which f32 products are f32: TF32 off for cuBLAS and
    cuDNN, restored after."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32,
                      torch.get_float32_matmul_precision())
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
        return self

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32, prec) = self.saved
        torch.set_float32_matmul_precision(prec)
        return False


# ---------------------------------------------------------------------------
# training: AdamW with global-norm clipping, as the configuration states
# ---------------------------------------------------------------------------
def wsd_lr(opt: dict, step: int) -> float:
    """The warmup-stable-decay learning rate at ``step`` (1-based)."""
    peak, w, s, dcy = (opt["peak_lr"], opt["warmup"], opt["stable"],
                       opt["decay"])
    if step < w:
        return peak * step / w
    if step < w + s:
        return peak
    frac = min(max((step - w - s) / dcy, 0.0), 1.0)
    return peak * opt["floor"] ** frac


def leaf_paths(c: dict) -> list[tuple]:
    return [p for p, _, _ in leaf_specs(c)]


def train_steps(c: dict, opt: dict, params: dict, batches: list, *,
                mode: str = "f32") -> dict:
    """Run AdamW over ``batches`` (each {"tokens", "labels"} (B, S) on the
    device) from ``params`` (f32, updated in place).  Returns each step's
    loss and, per leaf in :func:`leaf_specs` order, the norm of the first
    step's clipped gradient."""
    paths = leaf_paths(c)
    leaves = [get(params, p) for p in paths]
    for t in leaves:
        t.requires_grad_(True)
    m = [torch.zeros_like(t) for t in leaves]
    v = [torch.zeros_like(t) for t in leaves]
    losses, first = [], None
    with f32_matmuls():
        for n, b in enumerate(batches, start=1):
            for t in leaves:
                t.grad = None
            lv = loss(c, params, b["tokens"], b["labels"], mode=mode)
            lv.backward()
            losses.append(float(lv.detach()))
            grads = [t.grad for t in leaves]
            gnorm = torch.linalg.vector_norm(
                torch.stack([torch.linalg.vector_norm(g) for g in grads]))
            scale = min(1.0, opt["grad_clip"] / max(float(gnorm), 1e-9))
            lr = wsd_lr(opt, n)
            b1, b2 = opt["b1"], opt["b2"]
            with torch.no_grad():
                for g, t, mi, vi in zip(grads, leaves, m, v):
                    g = g * scale
                    mi.mul_(b1).add_(g, alpha=1 - b1)
                    vi.mul_(b2).addcmul_(g, g, value=1 - b2)
                    upd = (mi / (1 - b1 ** n)) / (
                        (vi / (1 - b2 ** n)).sqrt() + opt["eps"])
                    if t.ndim >= 2:
                        upd = upd + opt["weight_decay"] * t
                    t.sub_(lr * upd)
            if first is None:
                first = [float(torch.linalg.vector_norm(g * scale))
                         for g in grads]
            for t in leaves:
                t.grad = None
    for t in leaves:
        t.requires_grad_(False)
    return {"losses": losses, "grad_norms": first}
