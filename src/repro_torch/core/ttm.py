"""Tensor-Train-Matrix (TTM) algebra (paper §2, Appendix A) — the port of
``repro/core/ttm.py``.

A weight matrix ``W ∈ R^{J×I}`` with ``I = ∏ I_n``, ``J = ∏ J_n`` is
represented by ``d`` cores ``G_n ∈ R^{R_{n-1} × J_n × I_n × R_n}`` with
``R_0 = R_d = 1``:

    W(j_1..j_d, i_1..i_d) = G_1(:,j_1,i_1,:) @ ... @ G_d(:,j_d,i_d,:)

``ttm_matvec`` is the einsum chain of paper Eqs. (8)-(10); ``ttm_matvec_pe``
runs the same chain through the two canonical PE forms (Eqs. 5-6) with the
reshapes of paper Table 3. ``TTMatvec`` is the training path: its forward
is ``ttm_matvec_pe`` on the PE1/PE2 kernels, its backward the paper's
Appendix A.2 — the full-weight gradient Ŵ from the PE3 kernel, core
gradients contracted from Ŵ (``core_grads_from_what``), and the input
gradient from the transposed chain on the same PE1/PE2 kernels.

Stacked cores (a leading group axis: the E experts of an MoE layer, each
core ``(E, R_{n-1}, J_n, I_n, R_n)``) take ``x (E, C, I)``: the chain runs
every group's product in the same PE launches (the kernels' grouped
form), Ŵ comes from grouped PE3 launches over windows of at most
``WHAT_CAP`` elements (``what_windows``), and the core gradients are
contracted from each window's Ŵ.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device

# ---------------------------------------------------------------------------
# Shape factorization helpers
# ---------------------------------------------------------------------------


def _factorize(n: int, d: int) -> tuple[int, ...]:
    """Split integer ``n`` into ``d`` factors, as balanced as possible:
    the largest primes go greedily to the currently-smallest bucket, so
    e.g. 7168 -> (16, 28, 16) for d=3."""
    if d == 1:
        return (n,)
    primes: list[int] = []
    m = n
    p = 2
    while p * p <= m:
        while m % p == 0:
            primes.append(p)
            m //= p
        p += 1
    if m > 1:
        primes.append(m)
    buckets = [1] * d
    for q in sorted(primes, reverse=True):
        buckets[int(np.argmin(buckets))] *= q
    return tuple(sorted(buckets))


def auto_factorize(out_dim: int, in_dim: int,
                   d: int) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """Choose (J_1..J_d), (I_1..I_d) for a (out_dim, in_dim) matrix."""
    return _factorize(out_dim, d), _factorize(in_dim, d)


def clip_ranks(j_dims: tuple[int, ...], i_dims: tuple[int, ...],
               max_rank: int) -> tuple[int, ...]:
    """TT-ranks R_0..R_d: R_n <= min(prod_left, prod_right, max_rank)."""
    d = len(j_dims)
    ranks = [1]
    for n in range(1, d):
        left = math.prod(j_dims[:n]) * math.prod(i_dims[:n])
        right = math.prod(j_dims[n:]) * math.prod(i_dims[n:])
        ranks.append(int(min(left, right, max_rank)))
    ranks.append(1)
    return tuple(ranks)


@dataclass(frozen=True)
class TTMSpec:
    """Static description of one TTM-factorized matrix (out = J, in = I)."""
    j_dims: tuple[int, ...]
    i_dims: tuple[int, ...]
    ranks: tuple[int, ...]          # length d+1, ranks[0] == ranks[-1] == 1

    @property
    def d(self) -> int:
        return len(self.j_dims)

    @property
    def out_dim(self) -> int:
        return math.prod(self.j_dims)

    @property
    def in_dim(self) -> int:
        return math.prod(self.i_dims)

    @property
    def core_shapes(self) -> tuple[tuple[int, int, int, int], ...]:
        return tuple(
            (self.ranks[n], self.j_dims[n], self.i_dims[n], self.ranks[n + 1])
            for n in range(self.d))

    @property
    def num_params(self) -> int:
        return sum(math.prod(s) for s in self.core_shapes)

    @property
    def dense_params(self) -> int:
        return self.out_dim * self.in_dim

    @property
    def compression(self) -> float:
        return self.dense_params / max(self.num_params, 1)

    def transposed(self) -> "TTMSpec":
        """The spec of W^T: J and I swapped (its cores are
        ``G.permute(0, 2, 1, 3)``)."""
        return TTMSpec(self.i_dims, self.j_dims, self.ranks)


def make_spec(out_dim: int, in_dim: int, d: int, max_rank: int,
              j_dims: tuple[int, ...] | None = None,
              i_dims: tuple[int, ...] | None = None,
              ranks: tuple[int, ...] | None = None) -> TTMSpec:
    if j_dims is None or i_dims is None:
        j_auto, i_auto = auto_factorize(out_dim, in_dim, d)
        j_dims = j_dims or j_auto
        i_dims = i_dims or i_auto
    if math.prod(j_dims) != out_dim or math.prod(i_dims) != in_dim:
        raise ValueError(f"factors {j_dims} x {i_dims} do not give "
                         f"{out_dim} x {in_dim}")
    if ranks is None:
        ranks = clip_ranks(j_dims, i_dims, max_rank)
    return TTMSpec(tuple(j_dims), tuple(i_dims), tuple(ranks))


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def core_sigma(spec: TTMSpec, scale: float | None = None) -> float:
    """Per-core init std so that the reconstructed W has Glorot-like
    variance: var(W) = prod_n var(G_n) * prod_{n<d} R_n = 2 / (I + J)."""
    d = spec.d
    target_var = scale if scale is not None else 2.0 / (spec.in_dim
                                                        + spec.out_dim)
    rank_prod = math.prod(spec.ranks[1:d]) if d > 1 else 1.0
    return ((target_var / rank_prod) ** (1.0 / d)) ** 0.5


def init_cores(generator: torch.Generator, spec: TTMSpec,
               dtype=torch.float32, scale: float | None = None,
               device=None) -> list[torch.Tensor]:
    """Gaussian cores of std ``core_sigma`` from ``generator`` (which must
    live on ``device``; default ``"cuda"``)."""
    device = resolve_device(device)
    sigma = core_sigma(spec, scale)
    return [(torch.randn(spec.core_shapes[n], generator=generator,
                         device=device, dtype=torch.float32) * sigma
             ).to(dtype) for n in range(spec.d)]


# ---------------------------------------------------------------------------
# Contraction chain (paper Eqs. 8-10) — einsum path
# ---------------------------------------------------------------------------

def ttm_matvec(cores: list[torch.Tensor], x: torch.Tensor,
               spec: TTMSpec) -> torch.Tensor:
    """y = W x for batched input x: (..., I) -> (..., J), contracting
    right-to-left as paper Eqs. (8)-(10); each step is one reshaped
    product (b*left, acc, i_n*r_in) @ (i_n*r_in, r_out*j_n)."""
    d = spec.d
    batch_shape = tuple(x.shape[:-1])
    b = math.prod(batch_shape) if batch_shape else 1
    z = x.reshape(b, spec.in_dim)
    acc = 1
    r_in = 1
    for n in range(d - 1, -1, -1):
        i_n, j_n, r_out = spec.i_dims[n], spec.j_dims[n], spec.ranks[n]
        left = math.prod(spec.i_dims[:n]) if n > 0 else 1
        z = z.reshape(b * left, i_n * r_in, acc)
        gm = cores[n].permute(2, 3, 0, 1).reshape(i_n * r_in, r_out * j_n)
        z = torch.einsum("xkc,kd->xdc", z, gm)
        acc *= j_n
        r_in = r_out
        z = z.reshape(b * left, r_out * acc)
    return z.reshape(batch_shape + (spec.out_dim,))


def ttm_to_dense(cores: list[torch.Tensor], spec: TTMSpec) -> torch.Tensor:
    """Materialize W (J, I). Test/export only — O(J*I) memory."""
    d = spec.d
    w = cores[0].reshape(spec.j_dims[0] * spec.i_dims[0], spec.ranks[1])
    for n in range(1, d):
        g = cores[n].reshape(spec.ranks[n], -1)
        w = (w @ g).reshape(-1, spec.ranks[n + 1])
    w = w.reshape(sum(((spec.j_dims[n], spec.i_dims[n]) for n in range(d)),
                      ()))
    perm = list(range(0, 2 * d, 2)) + list(range(1, 2 * d, 2))
    return w.permute(perm).reshape(spec.out_dim, spec.in_dim)


def ttm_flops_matvec(spec: TTMSpec, batch: int) -> int:
    """MACs*2 of the Eq.(8)-(10) chain for ``batch`` rows."""
    d = spec.d
    total = 0
    for k in range(d):
        n = d - 1 - k
        left = math.prod(spec.i_dims[:n])
        right_j = math.prod(spec.j_dims[n + 1:]) if n + 1 < d else 1
        total += 2 * batch * left * right_j * spec.i_dims[n] \
            * spec.ranks[n + 1] * spec.ranks[n] * spec.j_dims[n]
    return total


# ---------------------------------------------------------------------------
# Canonical PE forms (paper Eqs. 5-6) — plain einsum references
# ---------------------------------------------------------------------------

def pe1_contract(z: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """PE1 (Eq. 5): Z'(a,d) = sum_{b,c} Z(a,b,c) * G(b,d,c)."""
    return torch.einsum("...abc,...bdc->...ad", z, g)


def pe2_contract(z: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """PE2 (Eq. 6): Z'(a,d,c) = sum_b Z(a,b,c) * G(b,d)."""
    return torch.einsum("...abc,...bd->...adc", z, g)


def pe3_outer(x: torch.Tensor, ybar: torch.Tensor) -> torch.Tensor:
    """PE3: batched outer product What(j, i) = sum_b Ybar(b,j) * X(b,i)."""
    return torch.einsum("bj,bi->ji", ybar, x)


def core_grads_from_what(what: torch.Tensor, cores: list[torch.Tensor],
                         spec: TTMSpec) -> list[torch.Tensor]:
    """Per-core gradients from the full-weight gradient Ŵ (paper Appendix
    A.2, Eqs. 14-19): ĝ_n = Ŵ contracted with every core except n, in f32
    (f64 stays f64), returned in each core's dtype. Stacked: Ŵ (E, J, I)
    and cores (E, R, J_n, I_n, R), each group's on its own."""
    d = spec.d
    lead = tuple(what.shape[:-2])
    g_l = "g" if lead else ""      # the group letter
    acc_t = torch.promote_types(what.dtype, torch.float32)
    wt = what.reshape(lead + spec.j_dims + spec.i_dims)
    o = len(lead)
    perm = list(range(o)) + [o + x for n in range(d) for x in (n, d + n)]
    wt = wt.permute(perm).reshape(
        lead + tuple(spec.j_dims[n] * spec.i_dims[n] for n in range(d)))
    cores3 = [c.reshape(lead + (spec.ranks[n], -1, spec.ranks[n + 1]))
              for n, c in enumerate(cores)]
    m_l = "abcdef"           # mode letters (d <= 6)
    r_l = "uvwxyzs"          # rank letters (d+1 <= 7)
    grads = []
    for n in range(d):
        subs = [g_l + m_l[:d]]
        ops = [wt.to(acc_t)]
        for k in range(d):
            if k == n:
                continue
            subs.append(g_l + r_l[k] + m_l[k] + r_l[k + 1])
            ops.append(cores3[k].to(acc_t))
        # boundary ranks R_0 == R_d == 1 never appear in the inputs when the
        # boundary core is the one being differentiated — drop the letter
        # and reshape instead.
        out = m_l[n]
        if n > 0:
            out = r_l[n] + out
        if n < d - 1:
            out = out + r_l[n + 1]
        g = torch.einsum(",".join(subs) + "->" + g_l + out, *ops)
        grads.append(g.reshape(cores[n].shape).to(cores[n].dtype))
    return grads


def ttm_matvec_pe(cores: list[torch.Tensor], x: torch.Tensor, spec: TTMSpec,
                  pe1=pe1_contract, pe2=pe2_contract) -> torch.Tensor:
    """Same result as ``ttm_matvec`` but routed through the two canonical
    PE forms with the exact reshapes of paper Table 3 (rows for Eqs.
    8-10). Pass kernel entry points (``kernels.ops.pe1/pe2``) as pe1/pe2.
    Stacked cores ``(E, R, J_n, I_n, R)`` take ``x (E, ..., I)``: every PE
    call carries the leading E (the kernels' grouped form)."""
    d = spec.d
    lead = tuple(cores[0].shape[:-4])
    o = len(lead)
    batch_shape = tuple(x.shape[o:-1])
    b = math.prod(batch_shape) if batch_shape else 1
    # Eq. (8): PE1 with a=b*I_1..I_{d-1}, b_dim=1, c=I_d, d_out=R_{d-1}*J_d
    rdm1, jd, idd = spec.ranks[d - 1], spec.j_dims[d - 1], spec.i_dims[d - 1]
    a = b * (math.prod(spec.i_dims[:d - 1]) if d > 1 else 1)
    z = x.reshape(lead + (a, 1, idd))
    gmat = cores[d - 1].reshape(lead + (1, rdm1 * jd, idd))
    z = pe1(z, gmat)                                    # (a, R_{d-1}*J_d)
    acc_j = jd
    # Eq. (9) steps: PE2 with c = accumulated J, b_dim = I_n*R_n,
    # d_out = R_{n-1}*J_n
    perm = tuple(range(o)) + (o + 2, o + 3, o, o + 1)
    for n in range(d - 2, -1, -1):
        r_in, r_out = spec.ranks[n + 1], spec.ranks[n]
        i_n, j_n = spec.i_dims[n], spec.j_dims[n]
        left = math.prod(spec.i_dims[:n]) if n > 0 else 1
        z = z.reshape(lead + (b * left, i_n * r_in, acc_j))
        gmat = cores[n].permute(perm).reshape(lead + (i_n * r_in,
                                                      r_out * j_n))
        z = pe2(z, gmat)                    # (b*left, r_out*j_n, acc_j)
        acc_j *= j_n
        z = z.reshape(lead + (-1, r_out * acc_j))
    return z.reshape(lead + batch_shape + (spec.out_dim,))


def pe_shapes(spec: TTMSpec, batch: int,
              groups: int = 0) -> list[tuple[str, tuple, tuple]]:
    """``(kind, Z shape, G shape)`` of every PE call ``ttm_matvec_pe`` makes
    for ``batch`` rows, in order (traced on meta tensors); ``groups`` > 0:
    the grouped chain of that many stacked cores, ``batch`` rows each."""
    seen = []

    def rec(kind, fn):
        def f(z, g):
            seen.append((kind, tuple(z.shape), tuple(g.shape)))
            return fn(z, g)
        return f
    lead = (groups,) if groups else ()
    cores = [torch.empty(lead + s, device="meta") for s in spec.core_shapes]
    ttm_matvec_pe(cores, torch.empty(lead + (batch, spec.in_dim),
                                     device="meta"),
                  spec, pe1=rec("pe1", pe1_contract),
                  pe2=rec("pe2", pe2_contract))
    return seen


# Ŵ of a grouped matvec is (E, J, I): every group's full weight. The
# backward takes it a window of groups at a time, each window at most this
# many elements (2^29: 1 GiB in bf16, 2 GiB once the core gradients read
# it in f32), so the peak stays a few GiB however many experts there are.
WHAT_CAP = 1 << 29


def what_windows(spec: TTMSpec, groups: int) -> list[tuple[int, int]]:
    """(start, stop) of the groups of each grouped PE3 launch: windows of
    ``max(1, WHAT_CAP // (J I))`` groups (``WHAT_CAP`` read at each call)."""
    w = max(1, WHAT_CAP // (spec.out_dim * spec.in_dim))
    return [(e, min(e + w, groups)) for e in range(0, groups, w)]


# ---------------------------------------------------------------------------
# Training path: the PE-kernel matvec with the paper's A.2 backward
# ---------------------------------------------------------------------------

def _kernel_chain(cores, x, spec):
    from ..kernels import ops
    return ttm_matvec_pe(cores, x, spec, pe1=ops.pe1, pe2=ops.pe2)


class TTMatvec(torch.autograd.Function):
    """y = W x with W in TT form, on the PE kernels (their plain versions
    on CPU tensors).

    forward:  ``ttm_matvec_pe`` through PE1/PE2.
    backward: Ŵ = PE3(ȳ, x); core gradients ``core_grads_from_what(Ŵ)``
              (plain einsum, as in ``repro``); dx = W^T ȳ through the
              transposed chain — cores ``G.permute(0, 2, 1, 3)`` on
              ``spec.transposed()`` — on the same PE1/PE2 kernels, only
              when the input needs a gradient.

    Stacked cores (E, ...) with x (E, C, I): the grouped chains, and Ŵ
    (E, J, I) from one grouped PE3 launch a window of ``what_windows``.
    """

    @staticmethod
    def forward(ctx, x, spec, *cores):
        ctx.spec = spec
        ctx.save_for_backward(x, *cores)
        return _kernel_chain(list(cores), x, spec)

    @staticmethod
    def backward(ctx, ybar):
        from ..kernels import ops
        x, *cores = ctx.saved_tensors
        spec = ctx.spec
        lead = tuple(cores[0].shape[:-4])
        ybar = ybar.contiguous()
        y2 = ybar.reshape(lead + (-1, spec.out_dim))
        dx = None
        if ctx.needs_input_grad[0]:
            cores_t = [c.transpose(-3, -2) for c in cores]
            dx = _kernel_chain(cores_t, ybar, spec.transposed()
                               ).reshape(x.shape)
        grads = [None] * len(cores)
        if any(ctx.needs_input_grad[2:]):
            x2 = x.reshape(lead + (-1, spec.in_dim))
            if not lead:
                what = ops.pe3(y2, x2)
                grads = core_grads_from_what(what, cores, spec)
            else:
                parts = []
                for e0, e1 in what_windows(spec, lead[0]):
                    what = ops.pe3(y2[e0:e1], x2[e0:e1])
                    parts.append(core_grads_from_what(
                        what, [c[e0:e1] for c in cores], spec))
                    del what
                grads = [torch.cat(g) if len(g) > 1 else g[0]
                         for g in zip(*parts)]
        return (dx, None, *grads)


def tt_matvec(cores: list[torch.Tensor], x: torch.Tensor,
              spec: TTMSpec) -> torch.Tensor:
    """The training matvec: ``TTMatvec`` (kernels forward and backward)."""
    return TTMatvec.apply(x, spec, *cores)
