"""Kernels B3, B5 and B7, the whole K-update DDPG, DQN and NAF learner
phases, and B9, the LRPG update: their plain torch twins and the wrappers
that launch csrc/ddpg_update.cu, csrc/dqn_update.cu and csrc/naf_update.cu
(whose shared row chains are csrc/row_chain.cuh) and csrc/lrpg_update.cu.

Replaces cartpoleplusplus_tpu/ops/learner_kernel.py::_update_kernel (made by
`ddpg_update_phase`). Per update k, on the presampled minibatch k:

  1. critic TD step: y = r + gamma (1 - done) Q'(s', mu'(s')), loss
     mean((Q(s, a) - y)^2), its gradient, Adam;
  2. actor step: loss -mean(Q(s, mu(s))) through the critic as updated in
     step 1 (actor_grad_critic="updated") or as it was before it ("pre"),
     its gradient through dQ/da, Adam;
  3. Polyak on both targets: t <- t + tau (theta - t).

Adam is optax.adam with the bias corrections computed as 1 - exp(t log b)
and an optional linear lr schedule keyed on the Adam count (`_sched_lr`).
The twin below is the same math as the JAX twin (`update_phase_math`,
learner_kernel.py:506) written over the port's parameter layout.

Parameter layout (the 8 groups). Each of actor, critic, actor target,
critic target and the four Adam moments (m_a, v_a, m_c, v_c) is ONE
contiguous float32 buffer holding the network's parameters in
`module.parameters()` order, each row-major in its torch shape:

    torso.0.weight (H0, in0), torso.0.bias (H0), ..., torso.{L-1}.*,
    norms.0.weight (H0), norms.0.bias (H0), ..., norms.{L-1}.*,
    head.weight (out, H_{L-1}), head.bias (out)

with in0 = obs_dim and in_l = H_{l-1}, except the critic's layer 1, whose
weight is (H1, H0 + action_dim): the action columns come last (the critic
joins the action after its first layer). The actor's head has out = 2,
the critic's out = 1. `actor_layout`/`critic_layout` give the (name, shape)
lists; agents/ddpg.py binds the modules' parameters and the Adam moments as
views of these buffers, so the kernel reads and updates them in place.

B5 (replaces learner_kernel.py::_dqn_update_kernel, made by
`dqn_update_phase`) runs K double-DQN updates on 4 groups (q, q_target and
q's Adam moments m, v) in `qnet_layout`, which is the actor's with a
5-wide linear head; its twin is `dqn_update_phase_math` (the JAX twin of
the same name, learner_kernel.py:828).

B7 (replaces learner_kernel.py::_naf_update_kernel, made by
`naf_update_phase`) runs K NAF updates on 4 groups (the NafNet, its target
and its Adam moments m, v) in `naf_layout`, the Q-net's with a 6-row head
[v, mu0, mu1, l0, l1, l2]: the MSE TD step toward the target's V, the
quadratic-advantage algebra of `naf_q`, an optional global-norm gradient
clip, Adam at the lr schedule, Polyak; its twin is `naf_update_phase_math`
(the JAX twin of the same name, learner_kernel.py:1110).

B9 (replaces learner_kernel.py::_lrpg_update_kernel, made by
`lrpg_update_phase`) takes ONE Adam step of the softmax policy gradient
with an entropy bonus over a whole rollout window, on 3 groups (the
policy and its Adam moments m, v) in `policy_layout` (PolicyMLP has
QNetMLP's structure); its twin is `lrpg_update_phase_math` (the JAX twin
of the same name, learner_kernel.py:1372).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import numpy as np
import torch

from ..models.nets import softplus
from ..utils import spans
from . import _native

_LN_EPS = 1e-6       # flax.linen.LayerNorm default epsilon
_ADAM_B1 = 0.9       # optax.adam defaults
_ADAM_B2 = 0.999
_ADAM_EPS = 1e-8
ACTION_DIM = 2
NUM_ACTIONS = 5      # the DQN head
NAF_HEAD = 6         # kHead in csrc/naf_update.cu: [v, mu0, mu1, l0, l1, l2]
_HUBER_DELTA = 1.0   # optax.huber_loss default


def _f32(x) -> float:
    """A host constant folded in double and rounded to float32 once, as the
    JAX twin's np.float32(...) constants are."""
    return float(np.float32(x))


# --------------------------------------------------------------------------
# The precision of the learners' matrix products: the reference's
# `learner_precision`, which traces its Pallas learners under
# jax.default_matmul_precision (learner_kernel.py::_with_mm_precision).
# --------------------------------------------------------------------------

# kMmF32 .. kMmF16 in csrc/learner_stages.cuh.
F32, BF16, TF32, X3, X6, F64, F16 = range(7)
_MM_MODES = {None: F32, "float32": F32, "highest": F32, "F32_F32_F32": F32,
             "bfloat16": BF16, "default": BF16, "BF16_BF16_F32": BF16,
             "tensorfloat32": TF32, "high": TF32,
             "BF16_BF16_F32_X3": X3, "BF16_BF16_F32_X6": X6,
             "F64_F64_F64": F64, "F16_F16_F16": F16}
# The values `learner_precision` takes: None (the ambient float32), the
# legacy names of jax.default_matmul_precision, and the dot-algorithm
# presets that the JAX package's kernel learners run on the CPU.
PRECISIONS = tuple(_MM_MODES)
# A name for each mode, in mode order.
MODE_NAMES = ("float32", "bfloat16", "tensorfloat32", "BF16_BF16_F32_X3",
              "BF16_BF16_F32_X6", "F64_F64_F64", "F16_F16_F16")
# X3's and X6's part products (indices into split_operand's parts) in the
# order they are summed, the smallest first.
_PASSES = {X3: ((1, 0), (0, 1), (0, 0)),
           X6: ((1, 1), (2, 0), (0, 2), (1, 0), (0, 1), (0, 0))}
# The modes at which B9 forms its products on the tensor cores (mm_tc in
# csrc/learner_stages.cuh: mma.sync on the rounded operands or the parts),
# and B3's (csrc/ddpg_update.cu's kTcMode: its X6 on the tensor cores did
# not hold phase 32's checks, its TF32 ran slower than the fmaf instance;
# PERF.md §6); B5, B7 and the other modes run the fmaf (DFMA) chains.
TC_MODES = (BF16, TF32, X3, X6, F16)
TC_MODES_OF = {"B3": (BF16, X3, F16), "B9": TC_MODES}
# kMmTcId: added to the mode in the id an instance reports (last_instance)
# where its products run on the tensor cores.
INSTANCE_TC = 16


def mm_mode(value) -> int:
    """The product mode of a `learner_precision` value, the port's reading
    of the JAX package's setting (which traces its Pallas learners under
    jax.default_matmul_precision(value)). Every product of B3, B5, B7, B9
    and their twins sums its terms from zero, in float32 unless stated; a
    product of two rounded operands or parts is exact there.

    F32: None, "float32", "highest", "F32_F32_F32": float32 operands (the
    default; the code that ran before the setting was ported).
    BF16: "bfloat16", "default", "BF16_BF16_F32": each operand rounded to
    bfloat16 (to nearest, ties to even): the TPU's one MXU pass.
    TF32: "tensorfloat32", "high": each operand rounded to TF32's 10
    mantissa bits (to nearest, ties away from zero, as cvt.rna.tf32.f32),
    what XLA computes for HIGH on a GPU; a TPU's HIGH is three bfloat16
    passes, so the port's "high" is less precise than the TPU's.
    X3, X6: "BF16_BF16_F32_X3" and "_X6", the TPU's multi-pass float32
    forms. Each operand x is split into bfloat16 parts (`split_operand`):
    hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid), each bf16
    rounding to nearest even by round_operand's integer operations, each
    residual exact in float32. X3 takes (hi, bf16(x - hi)) and sums lo.hi
    + hi.lo + hi.hi; X6 sums mid.mid + lo.hi + hi.lo + mid.hi + hi.mid +
    hi.hi (it drops mid.lo, lo.mid and lo.lo). The sum is float32 with the
    smallest terms first: the kernels add the parts term by term into their
    fmaf chains (per k), the twins pass by pass (a whole product per pass),
    so the two part by float32 roundings. A NaN or an infinity (or a value
    whose hi rounds past bfloat16's largest) goes whole into hi with zero
    residuals, so it meets a zero part of the other operand: such a
    product is NaN where float32's is infinite. hi + mid + lo == x for a
    normal x down to 2^-110 (below it the residuals fall under bfloat16's
    subnormal grid) and short of bfloat16's largest.
    F64: "F64_F64_F64": both operands widened to float64, the products and
    their sum in float64, the result rounded once to float32 where the dot
    goes on (LayerNorm, heads and Adam stay float32), as the JAX package
    computes it on the CPU. B9 sums a weight gradient over its window in
    float64 and rounds it once; its bias, LayerNorm and loss sums are no
    dots and stay float32 sums, as in the twin.
    F16: "F16_F16_F16": each operand rounded to float16 (to nearest even,
    float16's range: past 65504 to infinity, small values to its
    subnormals), products and sums in float32, the dot's result rounded to
    float16, as the JAX package computes it on the CPU.

    Every other value raises ValueError: the JAX package's kernel learners
    raise for them on the CPU too ("DEFAULT", "TF32_TF32_F32",
    "TF32_TF32_F32_X3", "BF16_BF16_F32_X9", "F16_F16_F32",
    "BF16_BF16_BF16", every "ANY_F8_*" name, and names
    jax.default_matmul_precision does not know)."""
    try:
        return _MM_MODES[value]
    except (KeyError, TypeError):
        raise ValueError(
            f"learner_precision={value!r} is not ported; the port takes "
            f"{PRECISIONS}, the values the JAX package's kernel learners "
            f"take on the CPU ({value!r} raises there too)") from None


def round_operand(x: torch.Tensor, mode: int) -> torch.Tensor:
    """x (float32) with every element rounded as a product operand of
    `mode` (mm_mode), as mm_in<M> in csrc/learner_stages.cuh: bfloat16 to
    nearest even and TF32 to nearest away from zero by integer operations
    on the float32 bits (a NaN unchanged, an infinity to itself, a value
    past the format's largest to the infinity), float16 to nearest even by
    the IEEE conversion. F32 returns x itself; X3, X6 and F64 take their
    operands whole (`split_operand`, `_mm`)."""
    if mode in (F32, X3, X6, F64):
        return x
    if mode == F16:
        return x.half().float()
    u = x.view(torch.int32)
    if mode == BF16:
        r = (u + (0x7FFF + ((u >> 16) & 1))) & -0x10000
    else:
        r = (u + 0x1000) & -0x2000
    return torch.where(torch.isnan(x), x, r.view(torch.float32))


def split_operand(x: torch.Tensor, mode: int) -> list:
    """X3's (hi, lo) or X6's (hi, mid, lo) bfloat16 parts of x (float32),
    as mm_in<kMmX3 / kMmX6> in csrc/learner_stages.cuh: each part
    round_operand(., BF16) of the residual before it, the residuals zero
    where hi is not finite."""
    hi = round_operand(x, BF16)
    rest = torch.where(torch.isfinite(hi), x - hi, torch.zeros_like(x))
    mid = round_operand(rest, BF16)
    if mode == X3:
        return [hi, mid]
    return [hi, mid, round_operand(rest - mid, BF16)]


def _mm(a, b, mode: int):
    """a @ b as `mode` (mm_mode) forms it: operands rounded (BF16, TF32,
    F16, the result rounded to float16 at F16), split into parts whose
    products are summed pass by pass, the smallest first (X3, X6), or
    widened to float64 and the result rounded once to float32 (F64)."""
    if mode in _PASSES:
        pa, pb = split_operand(a, mode), split_operand(b, mode)
        out = None
        for i, j in _PASSES[mode]:
            t = pa[i] @ pb[j]
            out = t if out is None else out + t
        return out
    if mode == F64:
        return (a.double() @ b.double()).float()
    out = round_operand(a, mode) @ round_operand(b, mode)
    return out.half().float() if mode == F16 else out


# --------------------------------------------------------------------------
# The layout of one group buffer.
# --------------------------------------------------------------------------

def _mlp_layout(ins, hidden, out: int) -> list:
    n = len(hidden)
    lay = []
    for i in range(n):
        lay += [(f"torso.{i}.weight", (hidden[i], ins[i])),
                (f"torso.{i}.bias", (hidden[i],))]
    for i in range(n):
        lay += [(f"norms.{i}.weight", (hidden[i],)),
                (f"norms.{i}.bias", (hidden[i],))]
    return lay + [("head.weight", (out, hidden[-1])), ("head.bias", (out,))]


def actor_layout(obs_dim: int, hidden: Sequence[int]) -> list:
    """(name, shape) of ActorMLP's parameters, in parameters() order."""
    hidden = tuple(hidden)
    return _mlp_layout((obs_dim,) + hidden[:-1], hidden, ACTION_DIM)


def critic_layout(obs_dim: int, hidden: Sequence[int]) -> list:
    """(name, shape) of CriticMLP's parameters (>= 2 hidden layers)."""
    hidden = tuple(hidden)
    ins = (obs_dim, hidden[0] + ACTION_DIM) + hidden[1:-1]
    return _mlp_layout(ins, hidden, 1)


def qnet_layout(obs_dim: int, hidden: Sequence[int]) -> list:
    """(name, shape) of QNetMLP's parameters, in parameters() order."""
    hidden = tuple(hidden)
    return _mlp_layout((obs_dim,) + hidden[:-1], hidden, NUM_ACTIONS)


def naf_layout(obs_dim: int, hidden: Sequence[int]) -> list:
    """(name, shape) of NafNet's parameters: QNetMLP's with a 6-row head."""
    hidden = tuple(hidden)
    return _mlp_layout((obs_dim,) + hidden[:-1], hidden, NAF_HEAD)


def policy_layout(obs_dim: int, hidden: Sequence[int]) -> list:
    """(name, shape) of PolicyMLP's parameters (QNetMLP's layout)."""
    return qnet_layout(obs_dim, hidden)


def layout_size(layout) -> int:
    return sum(int(np.prod(shape)) for _, shape in layout)


def group_views(buf: torch.Tensor, layout) -> list:
    """The parameters of one group as views of its flat buffer."""
    views, off = [], 0
    for _, shape in layout:
        n = int(np.prod(shape))
        views.append(buf[off:off + n].view(shape))
        off += n
    return views


def covers(obs_dim: int, hidden: Sequence[int]) -> bool:
    """The shapes B3 takes: any torso of at least 2 hidden layers (the
    action joins at layer 1), any width, as the reference's kernel
    (`ddpg_plan`)."""
    return len(tuple(hidden)) >= 2


def dqn_covers(obs_dim: int, hidden: Sequence[int]) -> bool:
    """The shapes B5 takes: any torso of at least 1 hidden layer, any
    width, as the reference's kernel (`dqn_plan`)."""
    return len(tuple(hidden)) >= 1


def _pad4(n: int) -> int:
    return (n + 3) // 4 * 4


def _r32(n: int) -> int:
    return -(-n // 32) * 32


# csrc/row_chain.cuh, the row chains of B3, B5 and B7.
_ROWS_F = 8              # kRowsF: a forward item's batch rows (B3, B5)
_LD_F = _ROWS_F + 4      # kLdF: the feature stride of its activations
_ROWS_N = 4              # kRowsN in csrc/naf_update.cu: B7's forward rows
_ROWS_A = 4              # kRowsA in csrc/ddpg_update.cu: B3's actor pass
_ROWS_B = 4              # kRowsB: a backward item's batch rows
_LD_B = _ROWS_B          # kLdB: the feature stride of its dz
_QLD = 8                 # kQLd: the stride of a row's head values
# kFixed: the weight ring (3 chunks of 256 x 36 floats) and a backward
# item's d loss / d head (4 rows of 8 floats).
_ROW_FIXED = 3 * 256 * 36 + _ROWS_B * _QLD
_B3_FWD_EXTRA = ACTION_DIM * _LD_F   # kFwdExtra in csrc/ddpg_update.cu


def _b3_bwd_extra(obs_dim: int, hidden: tuple) -> int:
    """bwd_extra in csrc/ddpg_update.cu: a backward item's dQ/da and d loss
    / d pre-tanh rows, then the critic's rest of the forward: its 4 rows'
    activations over max(obs_dim, widths) features and action rows."""
    ld4 = _ROWS_B + 4
    return (2 * _ROWS_B * _QLD + ld4 * max(obs_dim, *hidden)
            + ACTION_DIM * ld4)


def _row_plan(obs_dim: int, hidden: tuple, n_tab: int, spill: bool,
              fwd_extra: int = 0, bwd_extra: int = 0, rows_f: int = _ROWS_F):
    """row_plan in csrc/row_chain.cuh: (floats of an item's buffers rounded
    up to 32, spill, bytes of a block's dynamic shared memory). A forward
    item's buffers: its rows_f rows' activations, feature-major (stride
    rows_f + 4) over max(obs_dim, widths) features, their pre-LN rows,
    row-major at a stride of the widest layer padded to 4, and fwd_extra
    floats; a backward item's: its 4 rows of dh and their dz at that
    stride and bwd_extra floats. They sit in shared memory beside the
    weight ring and the device table (n_tab ints) unless that takes more
    than MAX_SMEM less 4 KB or `spill` asks for it, then in the
    workspace."""
    hmax = max(hidden)
    ldz = _pad4(hmax)
    fwd = (rows_f + 4) * max(obs_dim, hmax) + rows_f * ldz + fwd_extra
    bwd = (_ROWS_B + _LD_B) * ldz + bwd_extra
    bufs = max(fwd, bwd)
    spill = bool(spill) or 4 * (_ROW_FIXED + bufs + n_tab) > (
        _native.MAX_SMEM - 4096)
    return (_r32(bufs), spill,
            4 * (_ROW_FIXED + (0 if spill else bufs) + n_tab))


def dqn_plan(obs_dim: int, hidden: Sequence[int], batch: int,
             spill: bool = False):
    """B5's plan (dqn_row_plan in csrc/dqn_update.cu): (forward item rows,
    forward items, spill). A forward item runs one of the three passes
    through every layer for 8 batch rows (a backward item, 4 rows); an
    item's buffers sit in shared memory beside the weight ring unless that
    takes more than MAX_SMEM less 4 KB (one layer wider than 1468 at obs
    42) or `spill` asks for it, then in the workspace."""
    hidden = tuple(hidden)
    items = 3 * -(-batch // _ROWS_F)
    return (_ROWS_F, items,
            _row_plan(obs_dim, hidden, 6 * len(hidden), spill)[1])


def dqn_workspace_floats(obs_dim: int, hidden: Sequence[int], batch: int,
                         spill: bool = False) -> int:
    """Floats of B5's workspace (cp_dqn_workspace_floats), each piece
    rounded up to 32: per layer the online net's pre-LN rows on s, dz, dy
    and dy * xhat; the layer inputs past layer 0 and the last layer's
    output; d loss / dQ and the Huber terms; the three passes' Q values;
    on the spill route every forward item's buffers."""
    hidden = tuple(hidden)
    _, items, spill = dqn_plan(obs_dim, hidden, batch, spill)
    s, hl = sum(hidden), hidden[-1]
    tile = _row_plan(obs_dim, hidden, 6 * len(hidden), spill)[0]
    return (4 * _r32(batch * s) + _r32(batch * (s - hl)) + _r32(batch * hl)
            + _r32(batch * NUM_ACTIONS) + _r32(batch)
            + _r32(3 * batch * NUM_ACTIONS)
            + (items * tile if spill else 0))


def ddpg_plan(obs_dim: int, hidden: Sequence[int], batch: int,
              actor_grad_critic: str = "updated", spill: bool = False):
    """B3's plan (ddpg_row_plan in csrc/ddpg_update.cu): (forward item
    rows, the items of each forward and backward stage of an update in
    order, spill, bytes of a block's dynamic shared memory). At "updated"
    the critic's forward (8 rows an item: the target actor, the target
    critic's front (layer 0 and layer 1's sums before the action), the
    online critic), its backward (4 rows: the target critic's rest, TD,
    backward), then the actor's forward (4 rows: the actor, the critic's
    front) and backward (the critic's rest, its backward to dQ/da, the
    actor's); at "pre" one forward stage of all five passes (8 rows) and
    one backward stage of both chains. A forward item's buffers also hold its action rows, a
    backward item's dQ/da, d loss / d pre-tanh and the rest's rows; they
    spill past two layers of 1468 at obs 42."""
    hidden = tuple(hidden)
    tf, tb = -(-batch // _ROWS_F), -(-batch // _ROWS_B)
    ta = -(-batch // _ROWS_A)
    items = ((5 * tf, 2 * tb) if actor_grad_critic == "pre"
             else (3 * tf, tb, 2 * ta, tb))
    _, spill, smem = _row_plan(obs_dim, hidden, 10 * len(hidden), spill,
                               _B3_FWD_EXTRA, _b3_bwd_extra(obs_dim, hidden))
    return _ROWS_F, items, spill, smem


def ddpg_workspace_floats(obs_dim: int, hidden: Sequence[int], batch: int,
                          actor_grad_critic: str = "updated",
                          spill: bool = False) -> int:
    """Floats of B3's workspace (cp_ddpg_workspace_floats), each piece
    rounded up to 32: for the online critic on (s, a) per layer its pre-LN
    rows, dz, dy and dy * xhat, its layer inputs past layer 0 (the action
    joined at layer 1) and its last layer's output; the target critic's
    layer-1 sums before the action and a'; Q(s, a), the TD errors and d
    loss / dQ; for the actor on s the same rows (no action joined), for
    the critic on (s, pi(s)) its pre-LN rows and layer-1 sums before the
    action; pi(s), Q(s, pi(s)) and d loss / d pre-tanh; on the spill route
    the buffers of every item of the largest stage."""
    hidden = tuple(hidden)
    _, items, spill, _ = ddpg_plan(obs_dim, hidden, batch,
                                   actor_grad_critic, spill)
    s, hl, h1 = sum(hidden), hidden[-1], hidden[1]
    tile = _row_plan(obs_dim, hidden, 10 * len(hidden), spill,
                     _B3_FWD_EXTRA, _b3_bwd_extra(obs_dim, hidden))[0]
    critic = (4 * _r32(batch * s) + _r32(batch * (s - hl + ACTION_DIM))
              + _r32(batch * hl) + _r32(batch * h1)
              + _r32(batch * ACTION_DIM) + 3 * _r32(batch))
    actor = (5 * _r32(batch * s) + _r32(batch * (s - hl)) + _r32(batch * hl)
             + _r32(batch * h1) + 2 * _r32(batch * ACTION_DIM)
             + _r32(batch))
    return critic + actor + (max(items) * tile if spill else 0)


def naf_covers(obs_dim: int, hidden: Sequence[int]) -> bool:
    """The shapes B7 takes: B5's (any torso of at least 1 hidden layer,
    any width; `naf_plan`)."""
    return dqn_covers(obs_dim, hidden)


def naf_plan(obs_dim: int, hidden: Sequence[int], batch: int,
             spill: bool = False):
    """B7's plan (naf_row_plan in csrc/naf_update.cu): (forward item rows,
    the items of its forward and backward stages, spill, bytes of a
    block's dynamic shared memory). The forward stage runs the target on
    s' and the online net on s over 4-row tiles (128 items at batch 256),
    the backward stage 4-row tiles; the buffers spill past one layer of
    2449 at obs 42."""
    hidden = tuple(hidden)
    items = (2 * -(-batch // _ROWS_N), -(-batch // _ROWS_B))
    _, spill, smem = _row_plan(obs_dim, hidden, 6 * len(hidden), spill,
                               rows_f=_ROWS_N)
    return _ROWS_N, items, spill, smem


def naf_workspace_floats(obs_dim: int, hidden: Sequence[int], batch: int,
                         spill: bool = False) -> int:
    """Floats of B7's workspace (cp_naf_workspace_floats), each piece
    rounded up to 32: per layer the online net's pre-LN rows on s, dz, dy
    and dy * xhat; its layer inputs past layer 0 and its last layer's
    output; the target's V, the head rows and their gradients, the TD
    errors; the flat gradient of a clipped update, its 256 slices' partial
    sums and counts; on the spill route the buffers of every item of the
    larger stage."""
    hidden = tuple(hidden)
    _, items, spill, _ = naf_plan(obs_dim, hidden, batch, spill)
    s, hl = sum(hidden), hidden[-1]
    tile = _row_plan(obs_dim, hidden, 6 * len(hidden), spill,
                     rows_f=_ROWS_N)[0]
    size = layout_size(naf_layout(obs_dim, hidden))
    return (4 * _r32(batch * s) + _r32(batch * (s - hl)) + _r32(batch * hl)
            + 2 * _r32(batch) + 2 * _r32(batch * NAF_HEAD) + _r32(size)
            + 2 * 256 + (max(items) * tile if spill else 0))


_PG_ROWS = 64            # kPgRows in csrc/lrpg_update.cu: rows of a tile
_PG_LD = _PG_ROWS + 4    # kPgLd: a tile's feature stride
_PG_HEAD_LD = 8          # kPgHeadLd: the head's padded width
_PG_MAX_BLOCKS = 128     # kPgMaxBlocks: pass-1 blocks at most
PG_WORK_FLOATS = 1 << 27  # kPgWorkFloats: B9's workspace at most


def pg_tile_floats(obs_dim: int, hidden, spill: bool = False) -> int:
    """Floats of one B9 tile of 64 rows, as carve_tile in
    csrc/lrpg_update.cu counts them (a change to one is a change to both;
    tests/test_torch_cuda.py holds them together): feature-major buffers
    of stride 68 for the obs rows (two on the shared-memory route, one on
    the workspace route), every layer's pre-LN rows, one layer's relu
    rows, two gradient rows and the 5 logits; per layer the rows'
    LayerNorm statistics; the rows' loss terms."""
    hidden = tuple(hidden)
    feats = ((1 if spill else 2) * obs_dim + sum(hidden) + 3 * max(hidden)
             + NUM_ACTIONS)
    return feats * _PG_LD + (2 * len(hidden) + 1) * _PG_ROWS


def _acc_floats(mode: int) -> int:
    """Floats of one of B9's accumulators at `mode` (acc_floats in
    csrc/lrpg_update.cu): a double's two at F64."""
    return 2 if mode == F64 else 1


def _pad16(n: int) -> int:
    return -(-n // 16) * 16


def mma_row_words(mode: int, k: int) -> int:
    """32-bit words of a row of B9's packed weight copy at a tensor-core
    mode (mma_row_words in csrc/lrpg_update.cu) for k inputs: pad16(k)
    bfloat16 or float16 values two a word (TF32: one a word), and 4 words
    against bank conflicts."""
    return _pad16(k) + 4 if mode == TF32 else _pad16(k) // 2 + 4


def pg_weight_floats(obs_dim: int, hidden: Sequence[int],
                     mode: int = F32) -> int:
    """Floats (32-bit words) of B9's copy of the weights on the
    shared-memory route: at a tensor-core mode (TC_MODES) each matrix
    (every layer's W, then the head's) packed, its parts (2 at X3, 3 at
    X6, else 1) of pad16(outputs) rows of mma_row_words; else transposed
    to (in, out) with the outputs padded to 4 (the head's to 8)."""
    hidden = tuple(hidden)
    ins = (obs_dim,) + hidden
    outs = hidden + (NUM_ACTIONS,)
    if mode in TC_MODES:
        parts = {X3: 2, X6: 3}.get(mode, 1)
        return sum(parts * _pad16(n) * mma_row_words(mode, k)
                   for k, n in zip(ins, outs))
    return (sum(k * _pad4(h) for k, h in zip(ins, hidden))
            + hidden[-1] * _PG_HEAD_LD)


def pg_smem_floats(obs_dim: int, hidden: Sequence[int],
                   mode: int = F32) -> int:
    """Floats of B9's block on the shared-memory route (smem_floats in
    csrc/lrpg_update.cu): the weights' copy (`pg_weight_floats`), one
    accumulator per parameter and the loss (padded to 4; doubles at F64),
    and a tile with two obs buffers."""
    hidden = tuple(hidden)
    wt = pg_weight_floats(obs_dim, hidden, mode)
    p = layout_size(policy_layout(obs_dim, hidden))
    return (wt + _acc_floats(mode) * _pad4(p + 1)
            + pg_tile_floats(obs_dim, hidden))


def pg_tile_spills(obs_dim: int, hidden: Sequence[int],
                   mode: int = F32) -> bool:
    """Whether B9 takes the workspace route: its shared-memory block
    (`pg_smem_floats`) does not fit in one block's shared memory (one
    layer wider than 139, two wider than 84, three wider than 65, at obs
    42; at F64, whose accumulators are doubles, somewhat narrower), so the
    weights are read from the group buffer and the tile and the
    accumulators live in the block's slice of the workspace."""
    return 4 * pg_smem_floats(obs_dim, tuple(hidden), mode) > \
        _native.MAX_SMEM


def pg_tile_rows(obs_dim: int, hidden: Sequence[int]) -> int:
    """B9's tile rows (kPgRows in csrc/lrpg_update.cu): 64 on either
    route; 0 for a shape B9 does not take (no layer, or a width below
    1)."""
    hidden = tuple(hidden)
    if not hidden or min(hidden) < 1:
        return 0
    return _PG_ROWS


def pg_plan(obs_dim: int, hidden: Sequence[int], n_rows: int,
            mode: int = F32):
    """B9's pass-1 plan (plan in csrc/lrpg_update.cu): (tile rows, rows per
    block, blocks). The block count is at most 128 and at most
    PG_WORK_FLOATS / ((P + 1) a + tile) for P parameters (a: 2 at F64,
    else 1; tile: the workspace route's tile, else 0), so that the
    workspace of a wide network stays within 512 MB."""
    hidden = tuple(hidden)
    rows = pg_tile_rows(obs_dim, hidden)
    per = (layout_size(policy_layout(obs_dim, hidden)) + 1) * \
        _acc_floats(mode)
    if pg_tile_spills(obs_dim, hidden, mode):
        per += -(-pg_tile_floats(obs_dim, hidden, True) // 32) * 32
    cap = max(1, min(_PG_MAX_BLOCKS, PG_WORK_FLOATS // per))
    tiles = -(-n_rows // rows)
    rpb = -(-tiles // cap) * rows
    return rows, rpb, -(-n_rows // rpb)


def pg_workspace_floats(obs_dim: int, hidden: Sequence[int],
                        n_rows: int, mode: int = F32) -> int:
    """Floats of B9's workspace (cp_lrpg_workspace_floats): every block's
    partial row of P + 1 accumulators (doubles at F64; all of them rounded
    up to 32 floats) and, on the workspace route, every block's tile
    (rounded up to 32)."""
    hidden = tuple(hidden)
    _, _, blocks = pg_plan(obs_dim, hidden, n_rows, mode)
    p = layout_size(policy_layout(obs_dim, hidden))
    tile = (-(-pg_tile_floats(obs_dim, hidden, True) // 32) * 32
            if pg_tile_spills(obs_dim, hidden, mode) else 0)
    return (-(-blocks * (p + 1) * _acc_floats(mode) // 32) * 32
            + blocks * tile)


def lrpg_covers(obs_dim: int, hidden: Sequence[int]) -> bool:
    """The shapes B9 takes: any torso of at least 1 hidden layer, any
    width, as the reference's kernel. Where its block fits in shared
    memory (hidden (64, 64) at obs 42), the weights, the accumulators and
    the tile live there, wider in the workspace (`pg_tile_spills`)."""
    return pg_tile_rows(obs_dim, hidden) > 0


# --------------------------------------------------------------------------
# Batch-major MLP math. Activations are (B, F); weights are torch Linear
# (out, in). Every function mirrors the JAX function of the same name.
# --------------------------------------------------------------------------

def _ln_relu(z, s, t):
    """LayerNorm over features (one-pass variance, no clamp) + affine +
    relu. Returns (activation, xhat, inv, y)."""
    mu = z.mean(1, keepdim=True)
    var = (z * z).mean(1, keepdim=True) - mu * mu
    inv = torch.rsqrt(var + _LN_EPS)
    xh = (z - mu) * inv
    y = xh * s + t
    return torch.relu(y), xh, inv, y


def _ln_relu_bwd(dh, z, s, t):
    """Backward through relu + affine + LayerNorm for upstream dh, with the
    LN intermediates recomputed from the pre-LN z. Returns (dz, ds, dt)."""
    _, xh, inv, y = _ln_relu(z, s, t)
    dy = dh * (y > 0.0).to(dh.dtype)
    ds = (dy * xh).sum(0)
    dt = dy.sum(0)
    dxh = dy * s
    dz = inv * (dxh - dxh.mean(1, keepdim=True)
                - xh * (dxh * xh).mean(1, keepdim=True))
    return dz, ds, dt


def _unpack(flat, n: int):
    """A group's parameter list -> (Ws, bs, LN scales, LN biases, head W,
    head b)."""
    return (flat[0:2 * n:2], flat[1:2 * n:2], flat[2 * n:4 * n:2],
            flat[2 * n + 1:4 * n:2], flat[4 * n], flat[4 * n + 1])


def _pack(ws, bs, ss, ts, wh, bh) -> list:
    return ([x for pair in zip(ws, bs) for x in pair]
            + [x for pair in zip(ss, ts) for x in pair] + [wh, bh])


def mlp_fwd(obs, flat, hidden, mode: int = F32):
    """Torso + linear head, each product's operands rounded as `mode`
    (mm_mode) takes them. Returns (head pre-activation (B, out),
    residue)."""
    ws, bs, ss, ts, wh, bh = _unpack(flat, len(hidden))
    h, saved = obs, []
    for i in range(len(hidden)):
        z = _mm(h, ws[i].t(), mode) + bs[i]
        saved.append((h, z))
        h = _ln_relu(z, ss[i], ts[i])[0]
    return _mm(h, wh.t(), mode) + bh, (saved, h)


def mlp_bwd(dpre, flat, hidden, residue, mode: int = F32):
    """Grads for upstream d(pre-activation) (B, out), in `flat`'s order;
    the products' operands rounded as `mode` takes them, the bias and
    LayerNorm sums in float32."""
    n = len(hidden)
    ws, bs, ss, ts, wh, bh = _unpack(flat, n)
    saved, h_last = residue
    dwh = _mm(dpre.t(), h_last, mode)
    dbh = dpre.sum(0)
    dh = _mm(dpre, wh, mode)
    dws, dbs, dss, dts = [None] * n, [None] * n, [None] * n, [None] * n
    for i in reversed(range(n)):
        h_in, z = saved[i]
        dz, dss[i], dts[i] = _ln_relu_bwd(dh, z, ss[i], ts[i])
        dws[i] = _mm(dz.t(), h_in, mode)
        dbs[i] = dz.sum(0)
        if i > 0:
            dh = _mm(dz, ws[i], mode)
    return _pack(dws, dbs, dss, dts, dwh, dbh)


def actor_fwd(obs, flat, hidden, mode: int = F32):
    """Returns (a (B, 2), residue)."""
    pre, res = mlp_fwd(obs, flat, hidden, mode)
    a = torch.tanh(pre)
    return a, res + (a,)


def actor_bwd(da, flat, hidden, residue, mode: int = F32):
    saved, h_last, a = residue
    return mlp_bwd(da * (1.0 - a * a), flat, hidden, (saved, h_last), mode)


def critic_fwd(obs, act, flat, hidden, mode: int = F32):
    """Q(s, a) (B, 1); the action joins layer 1 as the split product
    h0 W1h^T + a W1a^T."""
    n, h0_dim = len(hidden), hidden[0]
    ws, bs, ss, ts, wh, bh = _unpack(flat, n)
    z0 = _mm(obs, ws[0].t(), mode) + bs[0]
    h0 = _ln_relu(z0, ss[0], ts[0])[0]
    z1 = (_mm(h0, ws[1][:, :h0_dim].t(), mode)
          + _mm(act, ws[1][:, h0_dim:].t(), mode) + bs[1])
    h = _ln_relu(z1, ss[1], ts[1])[0]
    saved = [(obs, z0), (h0, z1)]
    for i in range(2, n):
        z = _mm(h, ws[i].t(), mode) + bs[i]
        saved.append((h, z))
        h = _ln_relu(z, ss[i], ts[i])[0]
    return _mm(h, wh.t(), mode) + bh, (saved, h, act)


def critic_bwd(dq, flat, hidden, residue, need_param_grads: bool,
               need_daction: bool, mode: int = F32):
    """Backward through critic_fwd for upstream dq (B, 1). Returns (grads
    in `flat`'s order or None, d action (B, 2) or None)."""
    n, h0_dim = len(hidden), hidden[0]
    ws, bs, ss, ts, wh, bh = _unpack(flat, n)
    saved, h_last, act = residue
    dws, dbs, dss, dts = [None] * n, [None] * n, [None] * n, [None] * n
    dwh = _mm(dq.t(), h_last, mode)
    dbh = dq.sum(0)
    dh = _mm(dq, wh, mode)
    for i in reversed(range(2, n)):
        h_in, z = saved[i]
        dz, dss[i], dts[i] = _ln_relu_bwd(dh, z, ss[i], ts[i])
        dws[i] = _mm(dz.t(), h_in, mode)
        dbs[i] = dz.sum(0)
        dh = _mm(dz, ws[i], mode)
    h0, z1 = saved[1]
    dz1, dss[1], dts[1] = _ln_relu_bwd(dh, z1, ss[1], ts[1])
    daction = (_mm(dz1, ws[1][:, h0_dim:], mode) if need_daction
               else None)
    if not need_param_grads:
        return None, daction
    dws[1] = torch.cat([_mm(dz1.t(), h0, mode), _mm(dz1.t(), act, mode)],
                       dim=1)
    dbs[1] = dz1.sum(0)
    obs, z0 = saved[0]
    dz0, dss[0], dts[0] = _ln_relu_bwd(_mm(dz1, ws[1][:, :h0_dim], mode),
                                       z0, ss[0], ts[0])
    dws[0] = _mm(dz0.t(), obs, mode)
    dbs[0] = dz0.sum(0)
    return _pack(dws, dbs, dss, dts, dwh, dbh), daction


def critic_phase_block(actor_t, critic, critic_t, obs, nobs, act, rew,
                       done, gamma: float, inv_batch: float, hidden,
                       mode: int = F32):
    """Critic-TD gradient of one minibatch; rew/done are (B, 1) float.
    Returns (critic grads, loss)."""
    a_next = actor_fwd(nobs, actor_t, hidden, mode)[0]
    q_next = critic_fwd(nobs, a_next, critic_t, hidden, mode)[0]
    y = rew + _f32(gamma) * (1.0 - done) * q_next
    q, residue = critic_fwd(obs, act, critic, hidden, mode)
    td = q - y
    grads, _ = critic_bwd(_f32(2.0 * inv_batch) * td, critic, hidden,
                          residue, need_param_grads=True, need_daction=False,
                          mode=mode)
    return grads, _f32(inv_batch) * (td * td).sum()


def actor_phase_block(actor, critic, obs, inv_batch: float, hidden,
                      mode: int = F32):
    """Gradient of -mean Q(s, pi(s)) with respect to the actor, through
    `critic`. Returns (actor grads, loss)."""
    a, res_a = actor_fwd(obs, actor, hidden, mode)
    q, res_c = critic_fwd(obs, a, critic, hidden, mode)
    _, daction = critic_bwd(torch.full_like(q, _f32(-inv_batch)), critic,
                            hidden, res_c, need_param_grads=False,
                            need_daction=True, mode=mode)
    return actor_bwd(daction, actor, hidden, res_a, mode), \
        _f32(-inv_batch) * q.sum()


# --------------------------------------------------------------------------
# Adam and Polyak (componentwise).
# --------------------------------------------------------------------------

def _bias_corrections(tk: float):
    """(1 - b1^t, 1 - b2^t) as exp(t log b) in float32 (the kernel's form;
    t is the Adam count after the update)."""
    t = np.float32(tk)
    return tuple(float(np.float32(1.0) - np.exp(t * np.float32(np.log(b))))
                 for b in (_ADAM_B1, _ADAM_B2))


def adam_step(p, m, v, g, bc1: float, bc2: float, lr: float):
    """One optax.adam step: returns (p', m', v')."""
    m = _f32(_ADAM_B1) * m + _f32(1.0 - _ADAM_B1) * g
    v = _f32(_ADAM_B2) * v + _f32(1.0 - _ADAM_B2) * (g * g)
    p = p - lr * (m / bc1) / (torch.sqrt(v / bc2) + _f32(_ADAM_EPS))
    return p, m, v


def _sched_lr(lr: float, sched, tk: float) -> float:
    """optax.linear_schedule twin keyed on the Adam count: sched =
    (end_frac, transition_steps) or None (constant). tk is the count after
    the update, so the schedule count is tk - 1:
    lr(c) = lr + (lr end_frac - lr) min(c / T, 1), in float32."""
    if sched is None:
        return _f32(lr)
    end_frac, steps = sched
    frac = min((np.float32(tk) - np.float32(1.0)) / np.float32(steps),
               np.float32(1.0))
    return float(np.float32(lr) + frac * np.float32(lr * end_frac - lr))


def polyak_flat(target_list, online_list, tau: float):
    """theta' <- theta' + tau (theta - theta') over parameter lists."""
    return [t + _f32(tau) * (o - t) for t, o in zip(target_list, online_list)]


@torch.no_grad()
def update_phase_math(actor, critic, actor_t, critic_t, m_a, v_a, m_c, v_c,
                      batches, t0: int, hidden, *, actor_lr, critic_lr,
                      gamma, tau, actor_grad_critic: str = "updated",
                      lr_schedule=None, mm_precision=None):
    """K sequential DDPG updates on parameter lists (the layout above, one
    list per group). batches: (obs (K, B, F), action (K, B, 2), reward
    (K, B), next_obs (K, B, F), done (K, B)); t0 is the Adam count before
    the phase; mm_precision, a `learner_precision` value (mm_mode). Returns
    (actor, critic, actor_t, critic_t, m_a, v_a, m_c, v_c, closs (K,),
    aloss (K,)) as new tensors."""
    hidden = tuple(hidden)
    mode = mm_mode(mm_precision)
    k_updates, bm = batches[0].shape[0], batches[0].shape[1]
    inv = 1.0 / bm
    closses, alosses = [], []
    for k in range(k_updates):
        obs, act, rew, nobs, done = (x[k] for x in batches)
        rew = rew[:, None]
        done = done.to(torch.float32)[:, None]
        tk = float(t0 + k + 1)
        bc1, bc2 = _bias_corrections(tk)
        cg, closs = critic_phase_block(actor_t, critic, critic_t, obs, nobs,
                                       act, rew, done, gamma, inv, hidden,
                                       mode)
        pre_critic = critic
        lr = _sched_lr(critic_lr, lr_schedule, tk)
        new = [adam_step(p, m, v, g, bc1, bc2, lr)
               for p, m, v, g in zip(critic, m_c, v_c, cg)]
        critic, m_c, v_c = ([x[i] for x in new] for i in range(3))
        actor_critic = pre_critic if actor_grad_critic == "pre" else critic
        ag, aloss = actor_phase_block(actor, actor_critic, obs, inv, hidden,
                                      mode)
        lr = _sched_lr(actor_lr, lr_schedule, tk)
        new = [adam_step(p, m, v, g, bc1, bc2, lr)
               for p, m, v, g in zip(actor, m_a, v_a, ag)]
        actor, m_a, v_a = ([x[i] for x in new] for i in range(3))
        actor_t = polyak_flat(actor_t, actor, tau)
        critic_t = polyak_flat(critic_t, critic, tau)
        closses.append(closs)
        alosses.append(aloss)
    return (actor, critic, actor_t, critic_t, m_a, v_a, m_c, v_c,
            torch.stack(closses), torch.stack(alosses))


# --------------------------------------------------------------------------
# DQN (B5's twin).
# --------------------------------------------------------------------------

def dqn_phase_block(q, q_target, obs, nobs, act, rew, done, gamma: float,
                    inv_batch: float, hidden, double_dqn: bool,
                    mode: int = F32):
    """Huber TD gradient of one minibatch; act is (B,) int, rew/done (B, 1)
    float. The next action is the first-max argmax of the online net on s'
    (double DQN) or of the target net. Returns (grads in `q`'s order,
    loss)."""
    qt, _ = mlp_fwd(nobs, q_target, hidden, mode)
    sel = mlp_fwd(nobs, q, hidden, mode)[0] if double_dqn else qt
    first = torch.argmax(sel, dim=1, keepdim=True)   # first max, as jnp
    q_next = qt.gather(1, first)
    y = rew + _f32(gamma) * (1.0 - done) * q_next
    qs, residue = mlp_fwd(obs, q, hidden, mode)
    a = act.long()[:, None]
    td = qs.gather(1, a) - y
    d = _f32(_HUBER_DELTA)
    onehot = torch.zeros_like(qs).scatter_(1, a, 1.0)
    dq = (torch.clamp(td, -d, d) * _f32(inv_batch)) * onehot
    grads = mlp_bwd(dq, q, hidden, residue, mode)
    abs_td = td.abs()
    hub = torch.where(abs_td <= d, 0.5 * td * td, d * (abs_td - 0.5 * d))
    return grads, _f32(inv_batch) * hub.sum()


@torch.no_grad()
def dqn_update_phase_math(q, q_target, m, v, batches, t0: int, hidden, *,
                          lr, gamma, tau, double_dqn: bool = True,
                          mm_precision=None):
    """K sequential DQN updates on parameter lists (`qnet_layout`, one list
    per group): the Huber TD step, constant-lr Adam, Polyak. batches:
    (obs (K, B, F), action (K, B) int, reward (K, B), next_obs (K, B, F),
    done (K, B)); t0 is the Adam count before the phase; mm_precision as
    `update_phase_math` takes it. Returns (q, q_target, m, v, loss (K,))
    as new tensors."""
    hidden = tuple(hidden)
    mode = mm_mode(mm_precision)
    k_updates, bm = batches[0].shape[0], batches[0].shape[1]
    inv = 1.0 / bm
    losses = []
    for k in range(k_updates):
        obs, act, rew, nobs, done = (x[k] for x in batches)
        rew = rew[:, None]
        done = done.to(torch.float32)[:, None]
        bc1, bc2 = _bias_corrections(float(t0 + k + 1))
        grads, loss = dqn_phase_block(q, q_target, obs, nobs, act, rew, done,
                                      gamma, inv, hidden, double_dqn, mode)
        new = [adam_step(p, mm, vv, g, bc1, bc2, _f32(lr))
               for p, mm, vv, g in zip(q, m, v, grads)]
        q, m, v = ([x[i] for x in new] for i in range(3))
        q_target = polyak_flat(q_target, q, tau)
        losses.append(loss)
    return q, q_target, m, v, torch.stack(losses)


# --------------------------------------------------------------------------
# NAF (B7's twin).
# --------------------------------------------------------------------------

def _sigmoid(x):
    return 1.0 / (1.0 + torch.exp(-x))


def naf_q(pre, act):
    """Q (B, 1), and the residue for `naf_q_bwd`, from the packed head's
    pre-activations (B, 6) and the actions (B, 2): L = [[sp(l0), 0], [l1,
    sp(l2)]], u = L^T (a - mu), Q = v - |u|^2 / 2. As in the reference
    kernel, mu is the head's rows 1-2 without NafNet's tanh."""
    v, mu0, mu1 = pre[:, 0:1], pre[:, 1:2], pre[:, 2:3]
    l0, l1, l2 = pre[:, 3:4], pre[:, 4:5], pre[:, 5:6]
    da0, da1 = act[:, 0:1] - mu0, act[:, 1:2] - mu1
    l00, l11 = softplus(l0), softplus(l2)
    u0 = l00 * da0 + l1 * da1
    u1 = l11 * da1
    q = v - 0.5 * (u0 * u0 + u1 * u1)
    return q, (da0, da1, l00, l11, l0, l1, l2, u0, u1)


def naf_q_bwd(dq, residue):
    """d(pre-activations) (B, 6) for upstream dq (B, 1)."""
    da0, da1, l00, l11, l0, l1, l2, u0, u1 = residue
    du0 = -dq * u0
    du1 = -dq * u1
    dl00 = du0 * da0
    dl10 = du0 * da1
    dl11 = du1 * da1
    dda0 = du0 * l00
    dda1 = du0 * l1 + du1 * l11
    return torch.cat([dq, -dda0, -dda1, dl00 * _sigmoid(l0), dl10,
                      dl11 * _sigmoid(l2)], dim=1)


def naf_phase_block(params, target, obs, nobs, act, rew, done, gamma: float,
                    inv_batch: float, hidden, mode: int = F32):
    """MSE TD gradient of one minibatch toward y = r + gamma (1 - done)
    V'(s'); act is (B, 2), rew/done (B, 1) float. Returns (grads in
    `params`' order, loss)."""
    v_next = mlp_fwd(nobs, target, hidden, mode)[0][:, 0:1]
    y = rew + _f32(gamma) * (1.0 - done) * v_next
    pre, residue = mlp_fwd(obs, params, hidden, mode)
    q, qres = naf_q(pre, act)
    td = q - y
    dpre = naf_q_bwd(_f32(2.0 * inv_batch) * td, qres)
    return mlp_bwd(dpre, params, hidden, residue, mode), \
        _f32(inv_batch) * (td * td).sum()


def global_norm(grads):
    """sqrt of the sum over the list of each tensor's sum of squares."""
    gsq = torch.zeros((), dtype=torch.float32, device=grads[0].device)
    for g in grads:
        gsq = gsq + torch.sum(g * g)
    return torch.sqrt(gsq)


def clip_by_global_norm_flat(grads, max_norm: float):
    """optax.clip_by_global_norm on a parameter list, in the reference
    kernel's form: every gradient times 1 below max_norm, times max_norm /
    norm at or above it."""
    gn = global_norm(grads)
    m = _f32(max_norm)
    scale = torch.where(gn < m, torch.ones_like(gn), m / gn)
    return [g * scale for g in grads]


@torch.no_grad()
def naf_update_phase_math(params, target, m, v, batches, t0: int, hidden, *,
                          lr, gamma, tau, max_grad_norm: float = 0.0,
                          lr_schedule=None, mm_precision=None):
    """K sequential NAF updates on parameter lists (`naf_layout`, one list
    per group): the MSE TD step, the global-norm clip when max_grad_norm >
    0, Adam at the scheduled lr, Polyak. batches: (obs (K, B, F), action
    (K, B, 2), reward (K, B), next_obs (K, B, F), done (K, B)); t0 is the
    Adam count before the phase; mm_precision as `update_phase_math` takes
    it. Returns (params, target, m, v, loss (K,), the pre-clip global
    gradient norms (K,)) as new tensors."""
    hidden = tuple(hidden)
    mode = mm_mode(mm_precision)
    k_updates, bm = batches[0].shape[0], batches[0].shape[1]
    inv = 1.0 / bm
    losses, norms = [], []
    for k in range(k_updates):
        obs, act, rew, nobs, done = (x[k] for x in batches)
        rew = rew[:, None]
        done = done.to(torch.float32)[:, None]
        tk = float(t0 + k + 1)
        bc1, bc2 = _bias_corrections(tk)
        grads, loss = naf_phase_block(params, target, obs, nobs, act, rew,
                                      done, gamma, inv, hidden, mode)
        norms.append(global_norm(grads))
        if max_grad_norm > 0.0:
            grads = clip_by_global_norm_flat(grads, max_grad_norm)
        lr_k = _sched_lr(lr, lr_schedule, tk)
        new = [adam_step(p, mm, vv, g, bc1, bc2, lr_k)
               for p, mm, vv, g in zip(params, m, v, grads)]
        params, m, v = ([x[i] for x in new] for i in range(3))
        target = polyak_flat(target, params, tau)
        losses.append(loss)
    return params, target, m, v, torch.stack(losses), torch.stack(norms)


# --------------------------------------------------------------------------
# LRPG (B9's twin).
# --------------------------------------------------------------------------

def lrpg_phase_block(params, obs, act, adv, hidden, entropy_coef: float,
                     inv_n: float, mode: int = F32):
    """Softmax policy-gradient contribution of (B, F) window rows; act is
    (B,) int, adv (B, 1) float (already window-normalised). The gradient
    at the logits is closed-form,
        dlogits = inv_n (adv (p - onehot_a) + c p (logp + H)),
    so no autograd is needed. Returns (grads in `params`' order, loss
    contribution inv_n sum(-logp[a] adv - c H))."""
    logits, residue = mlp_fwd(obs, params, hidden, mode)
    zm = logits.max(1, keepdim=True).values
    ex = torch.exp(logits - zm)
    z = ex.sum(1, keepdim=True)
    p = ex / z
    logp = logits - zm - torch.log(z)
    onehot = torch.zeros_like(logits).scatter_(1, act.long()[:, None], 1.0)
    lp_a = (logp * onehot).sum(1, keepdim=True)
    ent = -(p * logp).sum(1, keepdim=True)
    coef, inv = _f32(entropy_coef), _f32(inv_n)
    dlogits = inv * (adv * (p - onehot) + coef * p * (logp + ent))
    grads = mlp_bwd(dlogits, params, hidden, residue, mode)
    return grads, inv * (-lp_a * adv - coef * ent).sum()


@torch.no_grad()
def lrpg_update_phase_math(params, m, v, window, t0: int, hidden, *, lr,
                           entropy_coef, mm_precision=None):
    """One LRPG Adam update on parameter lists (`policy_layout`, one list
    per group). window: (obs (N, F), action (N,) int, advantage (N,));
    t0 is the Adam count before the update; mm_precision as
    `update_phase_math` takes it. Returns (params, m, v, loss ()) as new
    tensors."""
    obs, act, adv = window
    grads, loss = lrpg_phase_block(params, obs, act, adv[:, None],
                                   tuple(hidden), entropy_coef,
                                   1.0 / obs.shape[0],
                                   mm_mode(mm_precision))
    bc1, bc2 = _bias_corrections(float(t0 + 1))
    new = [adam_step(p, mm, vv, g, bc1, bc2, _f32(lr))
           for p, mm, vv, g in zip(params, m, v, grads)]
    params, m, v = ([x[i] for x in new] for i in range(3))
    return params, m, v, loss


# --------------------------------------------------------------------------
# The wrappers.
# --------------------------------------------------------------------------

# Workspaces by (device, stream, shape): a call reuses its stream's buffer
# once the previous phase on that stream has finished with it.
_workspaces: dict = {}
# Per device, the ids the last launches of B3 and B9 wrote (LearnerDims::
# instance, PgDims::instance): int32 (2,), -1 before any launch.
_instances: dict = {}
_INSTANCE_SLOT = {"B3": 0, "B9": 1}


def _instance_ptr(dev, kernel: str) -> int:
    buf = _instances.get(dev)
    if buf is None:
        buf = _instances[dev] = torch.full((2,), -1, dtype=torch.int32,
                                           device=dev)
    return buf[_INSTANCE_SLOT[kernel]].data_ptr()


def last_instance(kernel: str, device) -> int:
    """The id that the last launch of `kernel` ("B3" or "B9") on `device`
    wrote from inside the kernel: its product mode (mm_mode), plus
    INSTANCE_TC where its products ran on the tensor cores (the kernel's
    TC_MODES_OF); -1 before any launch. Synchronises the device."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    buf = _instances.get(dev)
    return -1 if buf is None else int(buf[_INSTANCE_SLOT[kernel]])


def _check(t, shape, dtype, dev, what):
    if (t.device != dev or tuple(t.shape) != tuple(shape)
            or t.dtype != dtype or not t.is_contiguous()):
        raise ValueError(f"{what}: {tuple(t.shape)} {t.dtype} on {t.device}"
                         f"{'' if t.is_contiguous() else ' (strided)'}; want "
                         f"contiguous {tuple(shape)} {dtype} on {dev}")


def _layout_offsets(layout, n: int):
    """One network's parameter offsets in a group buffer: (per torso layer
    the offsets of W, b, LayerNorm scale and bias, flattened; the head's W
    and b offsets; the group's floats)."""
    offs, o = [], 0
    for _, shape in layout:
        offs.append(o)
        o += int(np.prod(shape))
    per_layer = tuple(x for i in range(n) for x in (
        offs[2 * i], offs[2 * i + 1], offs[2 * n + 2 * i],
        offs[2 * n + 2 * i + 1]))
    return per_layer, offs[4 * n], offs[4 * n + 1], o


@functools.lru_cache(maxsize=None)
def _learner_table(dev: torch.device, hidden: tuple,
                   *per_layer: tuple) -> torch.Tensor:
    """The device table of a learner kernel (Torso and NetLayout in
    csrc/learner_stages.cuh): the widths H_l, their prefix sums H_0 + ...
    + H_{l-1}, then each network's per-layer offsets. Made once per shape,
    so a launch copies no table from the host."""
    prefix = np.cumsum((0,) + hidden[:-1]).tolist()
    vals = list(hidden) + prefix + [x for offs in per_layer for x in offs]
    return torch.tensor(vals, dtype=torch.int32, device=dev)


@functools.lru_cache(maxsize=None)
def _learner_shape(dev, hidden: tuple, layouts: tuple):
    """(Torso, [NetLayout per layout], the host's copy of the widths) of a
    learner launch, the structures pointing into `_learner_table`; made
    once per shape (`layouts`: tuples of (name, shape) tuples)."""
    n = len(hidden)
    offs = [_layout_offsets(lay, n) for lay in layouts]
    tab = _learner_table(dev, hidden, *(o[0] for o in offs))
    base = tab.data_ptr()
    nets = [_native.NetLayout(lay=base + 4 * (2 * n + 4 * n * i), wh=wh,
                              bh=bh, size=size)
            for i, (_, wh, bh, size) in enumerate(offs)]
    return (_native.Torso(tab=base, num_layers=n), nets,
            (ctypes.c_int * n)(*hidden))


def _learner_consts(*, batch, actor_lr, critic_lr, gamma, tau,
                    lr_schedule) -> "_native.LearnerConsts":
    """The float32 constants of the twin, folded on the host."""
    end_frac, steps = lr_schedule if lr_schedule is not None else (1.0, 1)
    return _native.LearnerConsts(
        gamma=_f32(gamma), tau=_f32(tau), inv_batch=_f32(1.0 / batch),
        two_inv_batch=_f32(2.0 / batch), neg_inv_batch=_f32(-1.0 / batch),
        b1=_f32(_ADAM_B1), omb1=_f32(1.0 - _ADAM_B1), b2=_f32(_ADAM_B2),
        omb2=_f32(1.0 - _ADAM_B2), eps=_f32(_ADAM_EPS),
        log_b1=_f32(np.float32(np.log(_ADAM_B1))),
        log_b2=_f32(np.float32(np.log(_ADAM_B2))),
        ln_eps=_f32(_LN_EPS), actor_lr=_f32(actor_lr),
        critic_lr=_f32(critic_lr), sched_steps=_f32(steps),
        actor_lr_delta=_f32(actor_lr * end_frac - actor_lr),
        critic_lr_delta=_f32(critic_lr * end_frac - critic_lr),
        sched=int(lr_schedule is not None))


@torch.no_grad()
def ddpg_update_phase(groups, batches, t0: int, hidden, *, actor_lr: float,
                      critic_lr: float, gamma: float, tau: float,
                      actor_grad_critic: str = "updated", lr_schedule=None,
                      mm_precision=None):
    """B3: K DDPG updates on the 8 group buffers, IN PLACE.

    groups = (actor, critic, actor_t, critic_t, m_a, v_a, m_c, v_c), each a
    contiguous 1-D float32 buffer in the layout of this module's docstring;
    batches as `update_phase_math` takes them; t0 the Adam count before the
    phase; mm_precision, a `learner_precision` value (mm_mode: the
    precision of every product's operands). Returns (closs (K,), aloss
    (K,)).

    CUDA buffers launch the hand-written kernel (csrc/ddpg_update.cu) once,
    on the current stream; CPU buffers run `update_phase_math` and copy its
    results into the buffers. Any other device, a shape B3 does not cover
    (`covers`), or a malformed argument raises."""
    hidden = tuple(hidden)
    obs = batches[0]
    dev = groups[0].device
    with spans.span("cp.prep.B3"):
        if dev.type not in ("cuda", "cpu"):
            raise ValueError(f"ddpg_update_phase runs on cuda or cpu, not "
                             f"{dev}")
        if len(groups) != 8 or len(batches) != 5 or obs.dim() != 3:
            raise ValueError("want 8 group buffers and 5 batch tensors")
        k_updates, batch, obs_dim = obs.shape
        if not covers(obs_dim, hidden):
            raise ValueError(f"obs {obs_dim}, hidden {hidden}: not covered "
                             f"by B3 (ops.learner_kernel.covers)")
        if actor_grad_critic not in ("updated", "pre"):
            raise ValueError(f"actor_grad_critic={actor_grad_critic!r}")
        mode = mm_mode(mm_precision)
        if k_updates < 1 or batch < 1:
            raise ValueError(f"K {k_updates}, batch {batch}: need >= 1 each")
        lay_a, lay_c = actor_layout(obs_dim, hidden), critic_layout(obs_dim,
                                                                    hidden)
        lays = (lay_a, lay_c, lay_a, lay_c, lay_a, lay_a, lay_c, lay_c)
        for i, (g, lay) in enumerate(zip(groups, lays)):
            _check(g, (layout_size(lay),), torch.float32, dev, f"group {i}")
        for t, shape, dtype, what in (
                (batches[0], (k_updates, batch, obs_dim), torch.float32,
                 "obs"),
                (batches[1], (k_updates, batch, ACTION_DIM), torch.float32,
                 "action"),
                (batches[2], (k_updates, batch), torch.float32, "reward"),
                (batches[3], (k_updates, batch, obs_dim), torch.float32,
                 "next_obs"),
                (batches[4], (k_updates, batch), torch.bool, "done")):
            _check(t, shape, dtype, dev, what)
        kw = dict(actor_lr=actor_lr, critic_lr=critic_lr, gamma=gamma,
                  tau=tau)
        if dev.type == "cuda":
            launch = _ddpg_prepare(groups, batches, t0, hidden, kw,
                                   lr_schedule, actor_grad_critic == "pre",
                                   False, mode)

    if dev.type == "cpu":
        views = [group_views(g, lay) for g, lay in zip(groups, lays)]
        out = update_phase_math(*views, batches, t0, hidden,
                                actor_grad_critic=actor_grad_critic,
                                lr_schedule=lr_schedule,
                                mm_precision=mm_precision, **kw)
        for dst, src in zip(views, out[:8]):
            for d, s in zip(dst, src):
                d.copy_(s)
        return out[8], out[9]

    return launch()


def _ddpg_prepare(groups, batches, t0, hidden, kw, lr_schedule, merged,
                  spill, mode=F32):
    """One launch of csrc/ddpg_update.cu on checked CUDA inputs, made
    ready: the structures, the outputs and the workspace. Returns the
    launch, a call of no arguments that returns (closs, aloss). `spill`
    puts the row tiles' buffers in the workspace at any width; `mode`
    (mm_mode) picks the kernel's instance."""
    k_updates, batch, obs_dim = batches[0].shape
    dev = groups[0].device
    lay_a, lay_c = actor_layout(obs_dim, hidden), critic_layout(obs_dim,
                                                                hidden)
    torso, (net_a, net_c), widths = _learner_shape(
        dev, hidden, (tuple(lay_a), tuple(lay_c)))
    dims = _native.LearnerDims(
        obs_dim=obs_dim, batch=batch, k_updates=k_updates,
        merged=int(merged), torso=torso, actor=net_a, critic=net_c,
        spill=int(spill), mm=mode, instance=_instance_ptr(dev, "B3"))
    consts = _learner_consts(batch=batch, lr_schedule=lr_schedule, **kw)
    lib = _native.load_library()
    closs = torch.empty(k_updates, dtype=torch.float32, device=dev)
    aloss = torch.empty(k_updates, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    key = ("ddpg", dev, stream, obs_dim, batch, hidden, merged, spill)
    ws = _workspaces.get(key)
    if ws is None:
        size = lib.cp_ddpg_workspace_floats(_native.struct_ptr(dims), widths)
        if size <= 0:
            raise ValueError(f"B3 rejected dims {key}")
        ws = _workspaces[key] = torch.empty(size, dtype=torch.float32,
                                            device=dev)
    args = (_native.struct_ptr(dims), widths, _native.struct_ptr(consts),
            *(g.data_ptr() for g in groups),
            *(b.data_ptr() for b in batches),
            closs.data_ptr(), aloss.data_ptr(), ws.data_ptr(),
            ctypes.c_int(int(t0)), stream)

    def launch():
        with torch.cuda.device(dev):
            rc = lib.cp_ddpg_update_phase(*args)
        _native.check(lib, rc, "ddpg_update_phase")
        ddpg_update_phase.launches += 1
        return closs, aloss
    return launch


ddpg_update_phase.launches = 0


@torch.no_grad()
def dqn_update_phase(groups, batches, t0: int, hidden, *, lr: float,
                     gamma: float, tau: float, double_dqn: bool = True,
                     mm_precision=None):
    """B5: K DQN updates on the 4 group buffers, IN PLACE.

    groups = (q, q_target, m, v), each a contiguous 1-D float32 buffer in
    `qnet_layout`; batches as `dqn_update_phase_math` takes them, with
    int32 actions; t0 the Adam count before the phase; mm_precision as
    `ddpg_update_phase` takes it. Returns loss (K,).

    CUDA buffers launch the hand-written kernel (csrc/dqn_update.cu) once,
    on the current stream; CPU buffers run `dqn_update_phase_math` and copy
    its results into the buffers. Any other device, a shape B5 does not
    cover (`dqn_covers`), or a malformed argument raises."""
    hidden = tuple(hidden)
    obs = batches[0]
    dev = groups[0].device
    with spans.span("cp.prep.B5"):
        if dev.type not in ("cuda", "cpu"):
            raise ValueError(f"dqn_update_phase runs on cuda or cpu, not "
                             f"{dev}")
        if len(groups) != 4 or len(batches) != 5 or obs.dim() != 3:
            raise ValueError("want 4 group buffers and 5 batch tensors")
        k_updates, batch, obs_dim = obs.shape
        if not dqn_covers(obs_dim, hidden):
            raise ValueError(f"obs {obs_dim}, hidden {hidden}: not covered "
                             f"by B5 (ops.learner_kernel.dqn_covers)")
        mode = mm_mode(mm_precision)
        if k_updates < 1 or batch < 1:
            raise ValueError(f"K {k_updates}, batch {batch}: need >= 1 each")
        lay = qnet_layout(obs_dim, hidden)
        for i, g in enumerate(groups):
            _check(g, (layout_size(lay),), torch.float32, dev, f"group {i}")
        for t, shape, dtype, what in (
                (batches[0], (k_updates, batch, obs_dim), torch.float32,
                 "obs"),
                (batches[1], (k_updates, batch), torch.int32, "action"),
                (batches[2], (k_updates, batch), torch.float32, "reward"),
                (batches[3], (k_updates, batch, obs_dim), torch.float32,
                 "next_obs"),
                (batches[4], (k_updates, batch), torch.bool, "done")):
            _check(t, shape, dtype, dev, what)
        kw = dict(lr=lr, gamma=gamma, tau=tau, double_dqn=double_dqn)
        if dev.type == "cuda":
            launch = _dqn_prepare(groups, batches, t0, hidden, lr, gamma,
                                  tau, double_dqn, False, mode)

    if dev.type == "cpu":
        views = [group_views(g, lay) for g in groups]
        out = dqn_update_phase_math(*views, batches, t0, hidden,
                                    mm_precision=mm_precision, **kw)
        for dst, src in zip(views, out[:4]):
            for d, s in zip(dst, src):
                d.copy_(s)
        return out[4]

    return launch()


def _dqn_prepare(groups, batches, t0, hidden, lr, gamma, tau, double_dqn,
                 spill, mode=F32):
    """One launch of csrc/dqn_update.cu on checked CUDA inputs, made
    ready; returns the launch, a call of no arguments that returns the
    loss (K,). `spill` puts the row tiles' buffers in the workspace at any
    width; `mode` (mm_mode) picks the kernel's instance."""
    k_updates, batch, obs_dim = batches[0].shape
    dev = groups[0].device
    lay = qnet_layout(obs_dim, hidden)
    torso, (net,), widths = _learner_shape(dev, hidden, (tuple(lay),))
    dims = _native.DqnDims(obs_dim=obs_dim, batch=batch, k_updates=k_updates,
                           double_dqn=int(double_dqn), torso=torso, q=net,
                           spill=int(spill), mm=mode)
    # The Q-net is net 0 of the gradient stage: its lr rides in actor_lr.
    consts = _learner_consts(batch=batch, actor_lr=lr, critic_lr=lr,
                             gamma=gamma, tau=tau, lr_schedule=None)
    lib = _native.load_library()
    loss = torch.empty(k_updates, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    key = ("dqn", dev, stream, obs_dim, batch, hidden, spill)
    ws = _workspaces.get(key)
    if ws is None:
        size = lib.cp_dqn_workspace_floats(_native.struct_ptr(dims), widths)
        if size <= 0:
            raise ValueError(f"B5 rejected dims {key}")
        ws = _workspaces[key] = torch.empty(size, dtype=torch.float32,
                                            device=dev)
    args = (_native.struct_ptr(dims), widths, _native.struct_ptr(consts),
            *(g.data_ptr() for g in groups),
            *(b.data_ptr() for b in batches), loss.data_ptr(),
            ws.data_ptr(), ctypes.c_int(int(t0)), stream)

    def launch():
        with torch.cuda.device(dev):
            rc = lib.cp_dqn_update_phase(*args)
        _native.check(lib, rc, "dqn_update_phase")
        dqn_update_phase.launches += 1
        return loss
    return launch


dqn_update_phase.launches = 0


@torch.no_grad()
def naf_update_phase(groups, batches, t0: int, hidden, *, lr: float,
                     gamma: float, tau: float, max_grad_norm: float = 0.0,
                     lr_schedule=None, mm_precision=None):
    """B7: K NAF updates on the 4 group buffers, IN PLACE.

    groups = (params, target, m, v), each a contiguous 1-D float32 buffer
    in `naf_layout`; batches as `naf_update_phase_math` takes them, with
    float32 (K, B, 2) actions; t0 the Adam count before the phase; the
    clip applies when max_grad_norm > 0; lr_schedule = (end_frac,
    transition_steps) or None; mm_precision as `ddpg_update_phase` takes
    it. Returns loss (K,).

    CUDA buffers launch the hand-written kernel (csrc/naf_update.cu) once,
    on the current stream; CPU buffers run `naf_update_phase_math` and copy
    its results into the buffers. Any other device, a shape B7 does not
    cover (`naf_covers`), or a malformed argument raises."""
    hidden = tuple(hidden)
    obs = batches[0]
    dev = groups[0].device
    with spans.span("cp.prep.B7"):
        if dev.type not in ("cuda", "cpu"):
            raise ValueError(f"naf_update_phase runs on cuda or cpu, not "
                             f"{dev}")
        if len(groups) != 4 or len(batches) != 5 or obs.dim() != 3:
            raise ValueError("want 4 group buffers and 5 batch tensors")
        k_updates, batch, obs_dim = obs.shape
        if not naf_covers(obs_dim, hidden):
            raise ValueError(f"obs {obs_dim}, hidden {hidden}: not covered "
                             f"by B7 (ops.learner_kernel.naf_covers)")
        mode = mm_mode(mm_precision)
        if k_updates < 1 or batch < 1:
            raise ValueError(f"K {k_updates}, batch {batch}: need >= 1 each")
        lay = naf_layout(obs_dim, hidden)
        for i, g in enumerate(groups):
            _check(g, (layout_size(lay),), torch.float32, dev, f"group {i}")
        for t, shape, dtype, what in (
                (batches[0], (k_updates, batch, obs_dim), torch.float32,
                 "obs"),
                (batches[1], (k_updates, batch, ACTION_DIM), torch.float32,
                 "action"),
                (batches[2], (k_updates, batch), torch.float32, "reward"),
                (batches[3], (k_updates, batch, obs_dim), torch.float32,
                 "next_obs"),
                (batches[4], (k_updates, batch), torch.bool, "done")):
            _check(t, shape, dtype, dev, what)
        kw = dict(lr=lr, gamma=gamma, tau=tau, max_grad_norm=max_grad_norm,
                  lr_schedule=lr_schedule)
        if dev.type == "cuda":
            launch = _naf_prepare(groups, batches, t0, hidden, kw, False,
                                  mode)

    if dev.type == "cpu":
        views = [group_views(g, lay) for g in groups]
        out = naf_update_phase_math(*views, batches, t0, hidden,
                                    mm_precision=mm_precision, **kw)
        for dst, src in zip(views, out[:4]):
            for d, s in zip(dst, src):
                d.copy_(s)
        return out[4]

    return launch()


def _naf_prepare(groups, batches, t0, hidden, kw, spill, mode=F32):
    """One launch of csrc/naf_update.cu on checked CUDA inputs, made ready;
    returns the launch, a call of no arguments that returns the loss (K,).
    `spill` puts the row tiles' buffers in the workspace at any width;
    `mode` (mm_mode) picks the kernel's instance."""
    k_updates, batch, obs_dim = batches[0].shape
    dev = groups[0].device
    lay = naf_layout(obs_dim, hidden)
    torso, (net,), widths = _learner_shape(dev, hidden, (tuple(lay),))
    max_grad_norm = kw["max_grad_norm"]
    dims = _native.NafDims(
        obs_dim=obs_dim, batch=batch, k_updates=k_updates,
        max_norm=_f32(max_grad_norm) if max_grad_norm > 0.0 else 0.0,
        torso=torso, q=net, spill=int(spill), mm=mode)
    # The NafNet is net 0 of the gradient stage: its lr rides in actor_lr.
    consts = _learner_consts(batch=batch, actor_lr=kw["lr"],
                             critic_lr=kw["lr"], gamma=kw["gamma"],
                             tau=kw["tau"], lr_schedule=kw["lr_schedule"])
    lib = _native.load_library()
    loss = torch.empty(k_updates, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    key = ("naf", dev, stream, obs_dim, batch, hidden, spill)
    ws = _workspaces.get(key)
    if ws is None:
        size = lib.cp_naf_workspace_floats(_native.struct_ptr(dims), widths)
        if size <= 0:
            raise ValueError(f"B7 rejected dims {key}")
        ws = _workspaces[key] = torch.empty(size, dtype=torch.float32,
                                            device=dev)
    args = (_native.struct_ptr(dims), widths, _native.struct_ptr(consts),
            *(g.data_ptr() for g in groups),
            *(b.data_ptr() for b in batches), loss.data_ptr(),
            ws.data_ptr(), ctypes.c_int(int(t0)), stream)

    def launch():
        with torch.cuda.device(dev):
            rc = lib.cp_naf_update_phase(*args)
        _native.check(lib, rc, "naf_update_phase")
        naf_update_phase.launches += 1
        return loss
    return launch


naf_update_phase.launches = 0


@torch.no_grad()
def lrpg_update_phase(groups, window, t0: int, hidden, *, lr: float,
                      entropy_coef: float, mm_precision=None):
    """B9: one LRPG update on the 3 group buffers, IN PLACE.

    groups = (params, m, v), each a contiguous 1-D float32 buffer in
    `policy_layout`; window = (obs (N, F) float32, action (N,) int32,
    advantage (N,) float32); t0 the Adam count before the update;
    mm_precision as `ddpg_update_phase` takes it. Returns the window's
    loss ().

    CUDA buffers launch the hand-written kernel (csrc/lrpg_update.cu, a
    gradient pass and an Adam pass) on the current stream, its weights,
    accumulators and tile in shared memory or, where they do not fit
    (`pg_tile_spills`), in the workspace. CPU buffers run `lrpg_update_phase_math` and copy its
    results into the buffers. Any other device, a shape B9 does not cover
    (`lrpg_covers`), or a malformed argument raises."""
    hidden = tuple(hidden)
    dev = groups[0].device
    with spans.span("cp.prep.B9"):
        if dev.type not in ("cuda", "cpu"):
            raise ValueError(f"lrpg_update_phase runs on cuda or cpu, not "
                             f"{dev}")
        if len(groups) != 3 or len(window) != 3 or window[0].dim() != 2:
            raise ValueError("want 3 group buffers and 3 window tensors")
        n, obs_dim = window[0].shape
        if not lrpg_covers(obs_dim, hidden):
            raise ValueError(f"obs {obs_dim}, hidden {hidden}: not covered "
                             f"by B9 (ops.learner_kernel.lrpg_covers)")
        mode = mm_mode(mm_precision)
        if n < 1:
            raise ValueError("the window has no rows")
        lay = policy_layout(obs_dim, hidden)
        for i, g in enumerate(groups):
            _check(g, (layout_size(lay),), torch.float32, dev, f"group {i}")
        for t, shape, dtype, what in (
                (window[0], (n, obs_dim), torch.float32, "obs"),
                (window[1], (n,), torch.int32, "action"),
                (window[2], (n,), torch.float32, "advantage")):
            _check(t, shape, dtype, dev, what)
        if dev.type == "cuda":
            launch = _lrpg_prepare(groups, window, t0, hidden, lr,
                                   entropy_coef,
                                   pg_tile_spills(obs_dim, hidden, mode),
                                   mode)

    if dev.type == "cpu":
        views = [group_views(g, lay) for g in groups]
        out = lrpg_update_phase_math(*views, window, t0, hidden, lr=lr,
                                     entropy_coef=entropy_coef,
                                     mm_precision=mm_precision)
        for dst, src in zip(views, out[:3]):
            for d, s in zip(dst, src):
                d.copy_(s)
        return out[3]
    return launch()


def _lrpg_prepare(groups, window, t0, hidden, lr, entropy_coef, spill,
                  mode=F32):
    """One launch of csrc/lrpg_update.cu on checked CUDA inputs, made
    ready; returns the launch, a call of no arguments that returns the
    loss (). On the workspace route if `spill`, else on the shared-memory
    route (where its block does not fit there, the library rejects the
    dims); `mode` (mm_mode) picks the kernel's instance."""
    n, obs_dim = window[0].shape
    dev = groups[0].device
    torso, (net,), widths = _learner_shape(
        dev, hidden, (tuple(policy_layout(obs_dim, hidden)),))
    dims = _native.PgDims(obs_dim=obs_dim, n_rows=n, spill=int(spill),
                          torso=torso, net=net, mm=mode,
                          instance=_instance_ptr(dev, "B9"))
    bc1, bc2 = _bias_corrections(float(t0 + 1))
    consts = _native.PgConsts(
        inv_n=_f32(1.0 / n), coef=_f32(entropy_coef), lr=_f32(lr),
        b1=_f32(_ADAM_B1), omb1=_f32(1.0 - _ADAM_B1), b2=_f32(_ADAM_B2),
        omb2=_f32(1.0 - _ADAM_B2), eps=_f32(_ADAM_EPS), bc1=bc1, bc2=bc2,
        ln_eps=_f32(_LN_EPS))
    lib = _native.load_library()
    loss = torch.empty((), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    key = ("lrpg", dev, stream, obs_dim, n, hidden, spill, _acc_floats(mode))
    ws = _workspaces.get(key)
    if ws is None:
        size = lib.cp_lrpg_workspace_floats(_native.struct_ptr(dims), widths)
        if size <= 0:
            raise ValueError(f"B9 rejected dims {key}")
        ws = _workspaces[key] = torch.empty(size, dtype=torch.float32,
                                            device=dev)
    args = (_native.struct_ptr(dims), widths, _native.struct_ptr(consts),
            *(g.data_ptr() for g in groups),
            *(w.data_ptr() for w in window), loss.data_ptr(), ws.data_ptr(),
            stream)

    def launch():
        with torch.cuda.device(dev):
            rc = lib.cp_lrpg_update_phase(*args)
        _native.check(lib, rc, "lrpg_update_phase")
        lrpg_update_phase.launches += 1
        return loss
    return launch


lrpg_update_phase.launches = 0


# --------------------------------------------------------------------------
# The product probe (csrc/mm_probe.cu): the learners' product helpers alone.
# --------------------------------------------------------------------------

def _round_f32(s: np.ndarray, e: np.ndarray) -> np.ndarray:
    """float32 nearest (ties to even) to the exact s + e, where s is a
    float64 sum and e its exact error (|e| <= half an ulp of s): s rounded
    to float32, stepped once where s lies exactly halfway between two
    float32 values and e breaks the tie."""
    r = s.astype(np.float32)
    with np.errstate(over="ignore", invalid="ignore"):
        toward = np.nextafter(r, np.where(s > r.astype(np.float64),
                                          np.float32(np.inf),
                                          np.float32(-np.inf)))
        d = s - r.astype(np.float64)
        half = (toward.astype(np.float64) - r.astype(np.float64)) / 2.0
    step = (d != 0.0) & (d == half) & (e != 0.0) & (np.sign(e) == np.sign(d))
    return np.where(step, toward, r)


def _fmaf(a: np.ndarray, b: np.ndarray, acc: np.ndarray) -> np.ndarray:
    """fmaf(a, b, acc) elementwise on float32 arrays, exactly: a b is exact
    in float64, the sum's error by TwoSum, rounded once to float32."""
    p = a.astype(np.float64) * b.astype(np.float64)
    c = acc.astype(np.float64)
    s = c + p
    bb = s - c
    e = (c - (s - bb)) + (p - bb)
    return _round_f32(s, e)


def mm_chain(a: np.ndarray, b: np.ndarray, mode: int) -> np.ndarray:
    """A (rows, k) @ B (k, cols) (float32 numpy arrays) exactly as the
    probe's kernel forms it at `mode` (mm_in, mm_fma, mm_out of
    csrc/learner_stages.cuh): k in order from zero, each step one fmaf (a
    DFMA at F64; the part products one by one at X3 and X6), emulated
    bit for bit in float64 arithmetic. The probe's plain version."""
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    if mode in _PASSES:
        pa = [x.numpy() for x in split_operand(ta, mode)]
        pb = [x.numpy() for x in split_operand(tb, mode)]
        terms = _PASSES[mode]
    else:
        pa = [round_operand(ta, mode).numpy()]
        pb = [round_operand(tb, mode).numpy()]
        terms = ((0, 0),)
    rows, k = a.shape
    if mode == F64:
        acc = np.zeros((rows, b.shape[1]), np.float64)
        for q in range(k):
            acc = acc + (pa[0][:, q:q + 1].astype(np.float64)
                         * pb[0][q:q + 1, :].astype(np.float64))
        return acc.astype(np.float32)
    acc = np.zeros((rows, b.shape[1]), np.float32)
    for q in range(k):
        for i, j in terms:
            acc = _fmaf(pa[i][:, q:q + 1], pb[j][q:q + 1, :], acc)
    return acc.astype(np.float16).astype(np.float32) if mode == F16 else acc


def probe_operands(rng: np.random.RandomState, rows: int = 64,
                   k: int = 384, cols: int = 64):
    """The probe's operands A (rows, k), B (k, cols), float32, drawn from
    `rng` so that every mode's chain parts from every other's: normal
    draws (every mantissa bit set at random), and the second half of the k
    terms the first half's negation times (1 + 2^-12), so that each sum
    cancels to a small remainder after its terms have grown."""
    a = rng.normal(size=(rows, k)).astype(np.float32)
    b = rng.normal(size=(k, cols)).astype(np.float32)
    h = k // 2
    a[:, h:2 * h] = -a[:, :h] * np.float32(1 + 2.0 ** -12)
    b[h:2 * h] = b[:h]
    return a, b


def mm_probe(a: torch.Tensor, b: torch.Tensor, mode: int) -> torch.Tensor:
    """a (rows, k) @ b (k, cols), float32, through the product helpers of
    the learners at `mode` (mm_mode). CUDA tensors launch the probe kernel
    (csrc/mm_probe.cu) on the current stream; CPU tensors run its plain
    version, `mm_chain`."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"mm_probe: {tuple(a.shape)} @ {tuple(b.shape)}")
    if not 0 <= mode < len(MODE_NAMES):
        raise ValueError(f"mm_probe: mode {mode}")
    if a.device.type == "cpu":
        return torch.from_numpy(mm_chain(a.numpy(), b.numpy(), mode))
    a, b = a.contiguous(), b.contiguous()
    rows, k = a.shape
    out = torch.empty(rows, b.shape[1], dtype=torch.float32, device=a.device)
    lib = _native.load_library()
    with torch.cuda.device(a.device):
        rc = lib.cp_mm_probe(mode, a.data_ptr(), b.data_ptr(),
                             out.data_ptr(), rows, k, b.shape[1],
                             torch.cuda.current_stream().cuda_stream)
    _native.check(lib, rc, "mm_probe")
    return out


def mm_split(x: torch.Tensor, mode: int) -> torch.Tensor:
    """(n, 3): each element of x (float32, 1-D) as `mode` takes it into a
    product: X3's (hi, lo, 0), X6's (hi, mid, lo), else (round_operand, 0,
    0). CUDA tensors launch the probe's split kernel; CPU tensors run
    split_operand and round_operand."""
    if x.dim() != 1 or not 0 <= mode < len(MODE_NAMES):
        raise ValueError(f"mm_split: {tuple(x.shape)}, mode {mode}")
    if x.device.type == "cpu":
        parts = (split_operand(x, mode) if mode in _PASSES
                 else [round_operand(x, mode)])
        parts += [torch.zeros_like(x)] * (3 - len(parts))
        return torch.stack(parts, dim=1)
    x = x.contiguous()
    out = torch.empty(x.numel(), 3, dtype=torch.float32, device=x.device)
    lib = _native.load_library()
    with torch.cuda.device(x.device):
        rc = lib.cp_mm_split(mode, x.data_ptr(), out.data_ptr(), x.numel(),
                             torch.cuda.current_stream().cuda_stream)
    _native.check(lib, rc, "mm_split")
    return out


# --------------------------------------------------------------------------
# The tensor cores' probe (csrc/mm_probe.cu, cp_mma_probe): B3's and B9's
# fragment helpers alone.
# --------------------------------------------------------------------------

def mma_chain(a: np.ndarray, b: np.ndarray, mode: int) -> np.ndarray:
    """A (rows, k) @ B (k, cols) (float32 numpy arrays) as the tensor cores'
    helpers form it at `mode` (TC_MODES), where every k-block's part
    product is exact in float32 (`mma_probe_operands`): k in blocks of 16
    (8 at TF32, zeros past k), each block's part products in the order of
    _PASSES (one product at the other modes) summed exactly, each added
    into the float32 sum (round to nearest), then the dot's result rounded
    to float16 at F16. The tensor cores' probe's plain version."""
    if mode not in TC_MODES:
        raise ValueError(f"mma_chain: mode {mode} is no tensor-core mode")
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    if mode in _PASSES:
        pa = [x.numpy().astype(np.float64) for x in split_operand(ta, mode)]
        pb = [x.numpy().astype(np.float64) for x in split_operand(tb, mode)]
        terms = _PASSES[mode]
    else:
        pa = [round_operand(ta, mode).numpy().astype(np.float64)]
        pb = [round_operand(tb, mode).numpy().astype(np.float64)]
        terms = ((0, 0),)
    k, step = a.shape[1], 8 if mode == TF32 else 16
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k0 in range(0, k, step):
        for i, j in terms:
            block = pa[i][:, k0:k0 + step] @ pb[j][k0:k0 + step, :]
            acc = acc + block.astype(np.float32)
    return acc.astype(np.float16).astype(np.float32) if mode == F16 else acc


def mma_probe_operands(rng: np.random.RandomState, mode: int,
                       rows: int = 64, k: int = 200, cols: int = 40):
    """A (rows, k), B (k, cols), float32, whose block sums are exact in
    float32 at `mode` (TC_MODES), so that the tensor cores' probe matches
    `mma_chain` bit for bit whatever order the hardware adds a block in:
    random signs, magnitudes in (1, 2) with as many significant bits as
    the mode's parts hold (8; X3: 16, hi and lo), and at X6 hi (8 bits) +
    mid (8 bits, in 2^-9 (1, 2)) + lo (4 bits, in 2^-18 [1, 2)), each part
    what split_operand gives: every block's part products then lie on a
    grid some 20 bits below their largest. k past a multiple of the block
    exercises the zero padding."""

    def signs(shape):
        return rng.choice([-1.0, 1.0], shape)

    def draw(shape):
        if mode == X6:
            x = (1.0 + rng.randint(1, 128, shape) / 128.0
                 + signs(shape) * (1.0 + rng.randint(1, 128, shape) / 128.0)
                 * 2.0 ** -9
                 + signs(shape) * (1.0 + rng.randint(0, 8, shape) / 8.0)
                 * 2.0 ** -18)
        else:
            bits = 16 if mode == X3 else 8
            x = 1.0 + (rng.randint(1, 2 ** (bits - 1), shape)
                       * 2.0 ** (1 - bits))
        return (signs(shape) * x).astype(np.float32)

    return draw((rows, k)), draw((k, cols))


def mma_split(x: torch.Tensor, mode: int) -> torch.Tensor:
    """(n, 3): each element of x (float32, 1-D) as the tensor cores'
    helpers take it at `mode` (TC_MODES), as mm_split lays it out. CUDA
    tensors launch the probe's kernel of the hardware's conversions
    (cvt.rn.bf16x2, cvt.rn.f16x2, cvt.rna.tf32; cp_mma_split); CPU
    tensors run mm_split, whose bits they must give."""
    if x.dim() != 1 or mode not in TC_MODES:
        raise ValueError(f"mma_split: {tuple(x.shape)}, mode {mode}")
    if x.device.type == "cpu":
        return mm_split(x, mode)
    x = x.contiguous()
    out = torch.empty(x.numel(), 3, dtype=torch.float32, device=x.device)
    lib = _native.load_library()
    with torch.cuda.device(x.device):
        rc = lib.cp_mma_split(mode, x.data_ptr(), out.data_ptr(), x.numel(),
                              torch.cuda.current_stream().cuda_stream)
    _native.check(lib, rc, "mma_split")
    return out


def mma_probe(a: torch.Tensor, b: torch.Tensor, mode: int) -> torch.Tensor:
    """a (rows, k) @ b (k, cols), float32, through B3's and B9's tensor-core
    fragment helpers at `mode` (TC_MODES; rows a multiple of 16, cols of
    8): one warp a 16 x 8 tile, each k-block's part products one mma from
    zero, added into a float32 sum. CUDA tensors launch the probe kernel
    (csrc/mm_probe.cu, cp_mma_probe) on the current stream; CPU tensors
    run its plain version, `mma_chain`."""
    if (a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]
            or a.shape[0] % 16 or b.shape[1] % 8):
        raise ValueError(f"mma_probe: {tuple(a.shape)} @ {tuple(b.shape)}")
    if mode not in TC_MODES:
        raise ValueError(f"mma_probe: mode {mode} is no tensor-core mode")
    if a.device.type == "cpu":
        return torch.from_numpy(mma_chain(a.numpy(), b.numpy(), mode))
    a, b = a.contiguous(), b.contiguous()
    rows, k = a.shape
    out = torch.empty(rows, b.shape[1], dtype=torch.float32, device=a.device)
    lib = _native.load_library()
    with torch.cuda.device(a.device):
        rc = lib.cp_mma_probe(mode, a.data_ptr(), b.data_ptr(),
                              out.data_ptr(), rows, k, b.shape[1],
                              torch.cuda.current_stream().cuda_stream)
    _native.check(lib, rc, "mma_probe")
    return out

