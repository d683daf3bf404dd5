"""Fused moment pass of the align loop as a Pallas kernel for the GPU
(Triton route).

One call per align iteration produces what `pairwise.flow_and_step_moments`
produces, without writing any (N, M) matrix to device memory: the XLA path
materialises the pairwise distances, reads the carried gated color kernel
and writes the kernel matrix A before its (M, N) x (N, 35) contraction. Here
each program owns a block of moving points and loops over a range of fixed
points, builds the gated kernel tile in registers from the 3 + 5 wide
positions and features, and accumulates `tile^T @ U` in float32. Only the
per-split partial moment matrices and pair counts leave the kernel; a
deterministic sum over the splits and the shared O(M) epilogue
(`pairwise.flow_and_step_from_moments`) finish the pass.

Numerics (cvo.cpp:122-184): the same gates and kernel formulas as
`pairwise.cvo_kernel_from_color`. Distances are taken as direct coordinate
differences instead of the matmul identity, and the two clamped exponentials
are one exponential of the summed argument (identical for every pair that
passes the gates, whose exponents are bounded near -5). The contraction runs
in IEEE float32, never TF32 (`allow_tf32=False`): TF32 keeps about three
decimal digits, which flips borderline gates downstream.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..config import CvoParams
from ..ops import pairwise

U_WIDTH = 64          # the 35 moment monomials, padded to a power of two


@dataclasses.dataclass(frozen=True)
class Tiling:
    """Block shape of the moment kernel (all powers of two)."""
    block_m: int = 32      # moving points per program
    block_n: int = 32      # fixed points per inner-loop step
    splits: int = 8        # programs that share one moving block
    num_warps: int = 4
    num_stages: int = 2


# Fastest of a sweep over (block_m, block_n, splits, num_warps, num_stages)
# on an H100 80GB HBM3 at 3072 slots; see PERF.md.
DEFAULT = Tiling()


def _round_up(n: int, k: int) -> int:
    return -(-n // k) * k


def choose_tiling(n: int, t: Tiling = DEFAULT) -> Tiling:
    """Fewer fixed-axis splits for small clouds, so that every split keeps
    at least one inner step: 3072 slots keep all 8 splits, 200 use 4."""
    splits = t.splits
    while splits > 1 and t.block_n * splits > n:
        splits //= 2
    return dataclasses.replace(t, splits=splits)


def padded_sizes(n: int, m: int, t: Tiling) -> tuple[int, int]:
    """(fixed, moving) capacities the kernel runs at: the fixed axis padded
    to whole inner steps of every split, the moving axis to whole blocks.
    Padded slots are masked out and contribute exactly zero."""
    return _round_up(n, t.block_n * t.splits), _round_up(m, t.block_m)


def _kernel(scal_ref, xf_ref, mx_ref, u_ref, yf_ref, my_ref,
            mom_ref, cnt_ref, *, p: CvoParams, t, n_inner: int):
    i = pl.program_id(0)          # moving block
    s = pl.program_id(1)          # split of the fixed axis
    bm, bn = t.block_m, t.block_n
    d2t = scal_ref[0]
    inv2l2 = scal_ref[1]
    d2ct = float(pairwise.d2_color_threshold(p))
    inv2cl2 = 1.0 / (2.0 * p.c_ell * p.c_ell)
    s2cs2 = p.sigma * p.sigma * p.c_sigma * p.c_sigma

    rows = pl.ds(i * bm, bm)
    y = [plgpu.load(yf_ref.at[c, rows]) for c in range(8)]   # 8 x (bm,)
    my = plgpu.load(my_ref.at[rows]) > 0

    def body(k, carry):
        acc, cnt = carry
        cols = pl.ds((s * n_inner + k) * bn, bn)
        d2 = jnp.zeros((bn, bm), jnp.float32)
        for c in range(3):
            diff = plgpu.load(xf_ref.at[c, cols])[:, None] - y[c][None, :]
            d2 = d2 + diff * diff
        d2c = jnp.zeros((bn, bm), jnp.float32)
        for c in range(3, 8):
            diff = plgpu.load(xf_ref.at[c, cols])[:, None] - y[c][None, :]
            d2c = d2c + diff * diff
        mx = plgpu.load(mx_ref.at[cols]) > 0
        gate = (d2 < d2t) & (d2c < d2ct) & mx[:, None] & my[None, :]
        a = s2cs2 * jnp.exp(jnp.maximum(-(d2 * inv2l2 + d2c * inv2cl2),
                                        -20.0))
        keep = gate & (a > p.sp_thres)
        A = jnp.where(keep, a, 0.0)                    # (bn, bm)
        u = plgpu.load(u_ref.at[cols, :])              # (bn, U_WIDTH)
        acc = acc + pl.dot(A, u, trans_a=True, allow_tf32=False)
        cnt = cnt + jnp.sum(keep.astype(jnp.int32), axis=0)
        return acc, cnt

    acc0 = jnp.zeros((bm, U_WIDTH), jnp.float32)
    cnt0 = jnp.zeros((bm,), jnp.int32)
    acc, cnt = jax.lax.fori_loop(0, n_inner, body, (acc0, cnt0))
    plgpu.store(mom_ref.at[s, rows, :], acc)
    plgpu.store(cnt_ref.at[s, rows], cnt)


def pack_fixed(x, fx, mx, t: Tiling = None):
    """Loop-constant kernel inputs of the fixed cloud (it never moves during
    an alignment, cvo.cpp:336-341): (center, packed (8, NP) positions and
    features, (NP,) mask, (NP, U_WIDTH) moment basis, tiling)."""
    n = x.shape[0]
    t = t or choose_tiling(n)
    center, U = pairwise.step_moment_basis(x, mx)
    npad = padded_sizes(n, 1, t)[0] - n
    xf = jnp.pad(jnp.concatenate([x, fx], axis=1).T, ((0, 0), (0, npad)))
    m = jnp.pad(mx.astype(jnp.int32), (0, npad))
    u = jnp.pad(U, ((0, npad), (0, U_WIDTH - U.shape[1])))
    return center, xf, m, u, t


def moments(packed_fixed, y, fy, my, ell, p: CvoParams,
            interpret: bool = False):
    """(Mom (M, 35), nnz) of the moment pass for the current moving
    positions y; `packed_fixed` comes from pack_fixed."""
    _, xf, mx, u, t = packed_fixed
    m = y.shape[0]
    np_, mp = xf.shape[1], padded_sizes(1, m, t)[1]
    n_inner = np_ // (t.block_n * t.splits)
    yf = jnp.pad(jnp.concatenate([y, fy], axis=1).T, ((0, 0), (0, mp - m)))
    my_ = jnp.pad(my.astype(jnp.int32), (0, mp - m))
    ell = jnp.asarray(ell, jnp.float32)
    scal = jnp.stack([pairwise.d2_threshold(ell, p),
                      1.0 / (2.0 * ell * ell)]).astype(jnp.float32)
    mom, cnt = pl.pallas_call(
        functools.partial(_kernel, p=p, t=t, n_inner=n_inner),
        grid=(mp // t.block_m, t.splits),
        out_shape=[jax.ShapeDtypeStruct((t.splits, mp, U_WIDTH), jnp.float32),
                   jax.ShapeDtypeStruct((t.splits, mp), jnp.int32)],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=t.num_warps,
                                             num_stages=t.num_stages),
        interpret=interpret,
        name="cvo_moment_pass",
    )(scal, xf, mx, u, yf, my_)
    return jnp.sum(mom, axis=0)[:m, :35], jnp.sum(cnt)


def flow_and_step(packed_fixed, y, fy, my, ell, p: CvoParams,
                  interpret: bool = False):
    """Drop-in for pairwise.flow_and_step_moments: (omega, v, nnz, B, C, D,
    E) of one align iteration."""
    center = packed_fixed[0]
    Mom, nnz = moments(packed_fixed, y, fy, my, ell, p, interpret)
    return pairwise.flow_and_step_from_moments(Mom, y, center, ell, nnz, p)
