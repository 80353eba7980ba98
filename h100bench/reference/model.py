"""The plain reference's forward pass in float32 PyTorch, and the blocks
that every family's layer is built from.

The blocks: ``Linear`` (float32, or the bf16 witness's and the float8
control's rounding), RMSNorm, rotary embeddings (the rotate-half pairing
of the published checkpoints), causal attention in blocks of queries
with an optional sliding window in which a query sees itself and the
``window - 1`` positions before it, the SwiGLU MLP, and the residual
stream. Each family's layer (``h100bench/families/<model_type>.py``)
is written from its published description with them and lists its own
departures. Departures common to every family:

- weights are random (``h100bench/weights.py``), not trained;
- everything is float32 with TF32 off, where the published checkpoints
  are bf16.

The model runs layer by layer over every sequence of a sample, so only
one layer's weights are held at a time; attention runs in blocks of
queries and the unembedding in blocks of rows, so a sequence of 8192
tokens fits beside the weights.

``precision`` "fp8" gives the control: every matrix product but the
router's and the attention's takes its operands rounded to float8 e4m3
(weights scaled per output channel, activations per row), the precision
a later change might be tempted to serve in. "bf16" is a witness: the
same products with both operands and the product rounded to bf16, as a
bf16 server computes them, beside the float32 of everything else.
"""

from __future__ import annotations

import contextlib
import math

import torch

from h100bench import families, weights

Q_BLOCK = 1024
ROW_BLOCK = 2048
FP8_MAX = 448.0


@contextlib.contextmanager
def strict_float32():
    """TF32 off for matrix products and convolutions while the block
    runs (restored after)."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])


def _fp8_rows(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale per slice along
    ``dim`` (the amax maps to 448), returned in float32."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12)
    scale = amax / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


class Linear:
    """``x @ w`` for w ``[in, out]`` in float32, or with the operands
    rounded to ``precision`` ("fp8", or "bf16" with the product too)."""

    def __init__(self, w: torch.Tensor, precision: str):
        w = w.float()
        self.precision = precision
        self.w = {"fp8": lambda: _fp8_rows(w, dim=0),
                  "bf16": lambda: _bf16(w)}.get(precision, lambda: w)()

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.precision == "fp8":
            return _fp8_rows(x, dim=-1) @ self.w
        if self.precision == "bf16":
            return _bf16(_bf16(x) @ self.w)
        return x @ self.w


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w.float()


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of x [T, H, D] at positions 0..T-1, the first
    half of each head's channels paired with the second."""
    t, _, d = x.shape
    inv = 1.0 / theta ** (torch.arange(0, d, 2, device=x.device,
                                       dtype=torch.float64) / d)
    ang = torch.arange(t, device=x.device, dtype=torch.float64)[:, None] * inv
    cos = torch.cos(ang).float()[:, None, :]
    sin = torch.sin(ang).float()[:, None, :]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              window: int) -> torch.Tensor:
    """Causal attention of q [T, H, D] over k [T, Hkv, D] and v [T, Hkv,
    Dv], in blocks of queries; ``window`` > 0 lets a query see itself and
    the window - 1 positions before it."""
    t, h, d = q.shape
    rep = h // k.shape[1]
    k = k.repeat_interleave(rep, dim=1)
    v = v.repeat_interleave(rep, dim=1)
    out = q.new_empty(t, h, v.shape[-1])
    scale = 1.0 / math.sqrt(d)
    for lo in range(0, t, Q_BLOCK):
        hi = min(t, lo + Q_BLOCK)
        k_lo = max(0, lo - window + 1) if window else 0
        qp = torch.arange(lo, hi, device=q.device)[:, None]
        kp = torch.arange(k_lo, hi, device=q.device)[None, :]
        mask = kp <= qp
        if window:
            mask &= kp > qp - window
        s = torch.einsum("qhd,khd->hqk", q[lo:hi], k[k_lo:hi]) * scale
        s = s.masked_fill(~mask, float("-inf"))
        out[lo:hi] = torch.einsum("hqk,khd->qhd", torch.softmax(s, -1),
                                  v[k_lo:hi])
    return out


def swiglu(x: torch.Tensor, gate: Linear, up: Linear,
           down: Linear) -> torch.Tensor:
    """The SwiGLU MLP: down(silu(gate(x)) * up(x))."""
    return down(torch.nn.functional.silu(gate(x)) * up(x))


def residual(x: torch.Tensor, precision: str) -> torch.Tensor:
    """The residual stream after a sublayer adds to it: bf16 in the bf16
    witness, float32 otherwise."""
    return _bf16(x) if precision == "bf16" else x


def forward_logits(shape: dict, seed: int, seqs: list, device,
                   precision: str = "fp32", on_logits=None) -> None:
    """Run every token list of ``seqs`` through the model made from
    ``seed`` and call ``on_logits(i, lo, logits)`` with float32 logits
    of sequence i's positions lo.. in blocks of rows. Layer by layer:
    one layer's weights are made, used for every sequence, and freed."""
    with strict_float32(), torch.no_grad():
        top = weights.top_weights(shape, seed, device)
        xs = [top["embed"][torch.as_tensor(s, device=device)].float()
              for s in seqs]
        fam = families.of(shape)
        for i in range(shape["layers"]):
            layer = fam.reference_layer(
                shape, i, weights.layer_weights(shape, seed, i, device),
                precision)
            xs = [layer(x) for x in xs]
            del layer
        head = Linear(top["lm_head"], precision)
        for n, x in enumerate(xs):
            x = rms_norm(x, top["final_norm"], shape["eps"])
            for lo in range(0, x.shape[0], ROW_BLOCK):
                on_logits(n, lo, head(x[lo:lo + ROW_BLOCK]))
