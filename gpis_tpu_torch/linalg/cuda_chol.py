"""Kernels B, C, G, H, I, J, K and L (csrc/chol.cu) and the left-looking
blocked Cholesky and TRSM that loop B and C, and J and K under
`panel_solve="inv"` (port of gpis_tpu/linalg/pallas_chol.py:55-57, 87-687).

* `panel_update(m, j0, block)` -- Kernel B, replacing `panel_update_pallas`:
  m[j0:, j0:j0+B] -= m[j0:, :j0] @ m[j0:j0+B, :j0]^T, in place.
* `row_update(w, l_row, j0)` -- Kernel C, replacing `row_update_pallas`:
  l_row[:, :j0] @ w[:j0, :], columns >= j0 zero.
* `gemm_nt_masked(a, b, s, k0)` -- Kernel G, replacing
  `gemm_nt_masked_pallas`: s - a[:, :k0] @ b[:, :k0]^T, k0 a runtime value.
* `gemm_nn_acc_masked(u, a, b, w)` -- Kernel H, replacing
  `gemm_nn_acc_masked_pallas`: u[:, :w] += a @ b[:, :w], in place.
* `stripe_write(dst, blk, c0)` -- Kernel I, replacing `stripe_write_pallas`:
  dst[:, c0:c0+W] = blk, in place.
* `panel_scale(acc, v)` -- Kernel J, replacing `panel_scale_pallas`:
  acc @ v^T for v = Ljj^{-1} lower-triangular.
* `row_scale(v, rhs)` -- Kernel K, replacing `row_scale_pallas`: v @ rhs.
* `band_trail(s, l_col, wj, j0, row0)` -- Kernel L, replacing
  `band_trail_update_pallas`: S -= (l_col masked to global rows >= j0+B) @
  wj, in place on a rank's row band (`linalg.sharded.sharded_linv`).

G, H and I serve the out-of-core factor and TRSM (`linalg.outofcore`) and
take each operand as a row-major view with its own leading dimension, so a
stripe or a column slice of a wider buffer is passed without a copy; J, K
and L take their views the same way.  All but I are bound by arithmetic on
the card, I by bytes; csrc/chol.cu says how their loops skip the dead part
of each product.

B, C, G, H, J, K and L are one split-TF32 tensor-core kernel
(csrc/tc_nn.cuh; C, H, K and L its NN layout, G and J its NT layout, B G
and L in place), float32 only.  TMA reads their operands, so each view it
reads must start on 16 bytes with a leading dimension of a multiple of 4
floats (`_check_tma`; a view that is not raises ValueError -- there is no
staging copy), and `_tc_plan` cuts the work into 128 x 128 output tiles,
each over its live k range (for J and K, up to the tile's last column or
row of the triangular V), split into equal-depth units when the tiles
alone would not fill two waves of the card; a second kernel sums a split
tile's partials in a fixed order.  Around them, as in the JAX package, the
B x B potrf (`torch.linalg.cholesky_ex`), the panel and row triangular
solves (`torch.linalg.solve_triangular`) and, under `panel_solve="inv"`,
the B x B inverse V = Ljj^{-1} stay library calls.

`panel_solve` picks the factor's and TRSM's diagonal-block solve: "xla"
(the default, the JAX package's name for it) solves each (R, B) panel and
(B, N) row by substitution; "inv" forms V = Ljj^{-1} once (B x B) and
multiplies by it through J and K.  `PANEL_SOLVE` reads GPIS_PANEL_SOLVE
once, at import, as `pallas_chol._PANEL_SOLVE` does; a call's
`panel_solve=None` takes it.

Each wrapper hands a CUDA tensor to its kernel and a CPU tensor to its
plain twin (`*_reference`; `_build.takes_kernel`), and raises on anything
the kernel does not take: B, C, G, H, J, K and L take float32 only (float64
runs on the CPU), I float32 and float64.
"""

from __future__ import annotations

import functools
import math
import os

import torch

from gpis_tpu_torch import _build
from gpis_tpu_torch.utils import profiling

__all__ = ["panel_update", "panel_update_reference", "row_update", "row_update_reference",
           "gemm_nt_masked", "gemm_nt_masked_reference", "gemm_nn_acc_masked",
           "gemm_nn_acc_masked_reference", "stripe_write", "stripe_write_reference",
           "panel_scale", "panel_scale_reference", "row_scale", "row_scale_reference",
           "band_trail", "band_trail_reference", "PANEL_SOLVE", "blocked_cholesky",
           "blocked_linv"]

PANEL_SOLVE = os.environ.get("GPIS_PANEL_SOLVE", "xla").lower()


def _check_square(what: str, m: torch.Tensor) -> int:
    if m.ndim != 2 or m.shape[0] != m.shape[1]:
        raise ValueError(f"{what}: expected a square matrix, got {tuple(m.shape)}")
    return m.shape[0]


TC_TILE = 128  # output tile of the tensor-core body (tc_nn.cuh BM, BN)
TC_CHUNK = 32  # its k chunk (tc_nn.cuh BK)
TC_DEPTH = 256  # split units are a multiple of this deep


def _tc_plan(rows: int, cols: int, k_hi: int, *, triangle: bool = False, width: int = 0,
             upper: str | None = None, k_offset: int = 0, whole: bool = False,
             n_sm: int = 132):
    """The tensor-core product's work over output rows [0, rows), columns
    [0, cols) and k < k_hi, as (units, finish, n_slots); the same for both
    layouts of B (NN: C, H, K and L; NT: B, G, J, D and F, which take no
    triangle or width):

    * units: (m0, n0, kb, ke, slot), one CTA each: the 128 x 128 tile at
      (m0, n0) over k in [kb, ke).  A tile's k range starts at 0, or with
      `triangle` (W lower-triangular, so W[k, c] = 0 for k < c) at its first
      column n0.  It ends at k_hi, or with `upper` (a lower-triangular
      operand) after the tile's last column ("cols", J: V[c, k] = 0 for
      k > c) or last row ("rows", K, D and F: V[r, k] = 0 for k > r), at
      min(n0 or m0 + k_offset + 128, k_hi); k_offset is the global index of
      row 0 (F's W band at row0; 0 for a whole triangle).  slot -1: the unit
      owns its tile's whole range and writes the output; else it writes
      partial `slot`.
    * finish: (m0, n0, slot0, cnt): a split tile's partials [slot0, slot0 +
      cnt), summed in that order; with cnt 0, a tile with no live k (NT at
      k_hi 0, whose epilogue then copies S) and, for `width` > cols, the
      tiles at columns [round_up(cols, 128), width), which write zeros.
    * n_slots: the partials' count, the workspace's (n_slots, 128, 128).

    Tiles are split when there are fewer than two waves of them (n_sm CTAs a
    wave, one a streaming multiprocessor) and `whole` is not asked for; the
    units are then TC_DEPTH-multiples deep, about four to a multiprocessor,
    on k-chunk bounds.  So a tile at most TC_DEPTH deep is never cut: J's
    and K's, whose k range is one B = 256 block, are one unit each, and
    their plans have no partials and no finish tiles; nor is a tile of D or
    F (`whole`: the QUAD epilogue squares the tile's whole sum).  With
    `upper` the units come deepest first."""
    t = TC_TILE
    if upper not in (None, "cols", "rows"):
        raise ValueError(f"_tc_plan: upper must be None, 'cols' or 'rows', got {upper!r}")

    def end(m0, n0):
        return k_hi if upper is None else min((n0 if upper == "cols" else m0 + k_offset) + t,
                                              k_hi)

    tiles = [(m0, n0, n0 if triangle else 0, end(m0, n0)) for m0 in range(0, rows, t)
             for n0 in range(0, cols, t)]
    empty = [(m0, n0, 0, 0) for m0, n0, lo, hi in tiles if lo >= hi]
    tiles = [(m0, n0, lo, hi) for m0, n0, lo, hi in tiles if lo < hi]
    step = 0
    if len(tiles) < 2 * n_sm and not whole:
        depth = sum(hi - lo for _, _, lo, hi in tiles)
        step = max(TC_DEPTH, TC_DEPTH * math.ceil(depth / (4 * n_sm * TC_DEPTH)))
    units, finish, slot = [], [], 0
    for m0, n0, lo, hi in tiles:
        bounds = list(range(lo, hi, step)) if step else [lo]
        if len(bounds) == 1:
            units.append((m0, n0, lo, hi, -1))
            continue
        for i, kb in enumerate(bounds):
            ke = bounds[i + 1] if i + 1 < len(bounds) else hi
            units.append((m0, n0, kb, ke, slot + i))
        finish.append((m0, n0, slot, len(bounds)))
        slot += len(bounds)
    finish.extend(empty)
    for n0 in range(t * math.ceil(cols / t), width, t):
        finish.extend((m0, n0, 0, 0) for m0 in range(0, rows, t))
    if upper is not None:
        # Deepest units first (the card starts CTAs in index order): J's and
        # K's tiles are 128 or 256 deep, D's and F's 128 to C, and past one
        # wave the shallow ones then fill in behind the deep ones rather than
        # the other way round.
        units.sort(key=lambda u: u[2] - u[3])
    return units, finish, slot


@functools.lru_cache(maxsize=1024)
def _tc_plan_on(device: torch.device, rows: int, cols: int, k_hi: int, triangle: bool,
                width: int, upper: str | None, k_offset: int, whole: bool):
    """`_tc_plan` for the card `device`, as int32 tensors on it (cached: the
    factor and TRSM loops ask for the same plans fit after fit, and the
    queries for the same plans chunk after chunk)."""
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    units, finish, n_slots = _tc_plan(rows, cols, k_hi, triangle=triangle, width=width,
                                      upper=upper, k_offset=k_offset, whole=whole, n_sm=n_sm)

    def on_card(rows_, ncol):
        host = torch.tensor(rows_, dtype=torch.int32).reshape(-1, ncol).pin_memory()
        return host.to(device, non_blocking=True)

    return on_card(units, 5), on_card(finish, 4), n_slots


def _check_tma(what: str, *mats: torch.Tensor) -> None:
    """The tensor-core body reads its operands through TMA: each view must
    start on a 16-byte boundary and step rows by a multiple of 16
    bytes.  Every view of the factors and TRSMs qualifies (widths, panels
    and blocks are multiples of 4 columns); a view that does not raises, as
    there is no staging copy."""
    for t in mats:
        if t.data_ptr() % 16 or (t.shape[0] > 1 and t.stride(0) % 4):
            raise ValueError(f"{what}: a float32 view at byte offset {t.data_ptr() % 16} mod 16 "
                             f"with leading dimension {t.stride(0)} is not addressable by TMA "
                             "(16-byte aligned start and rows)")


def _tc_launch_args(what: str, a: torch.Tensor, b: torch.Tensor | None, rows: int, cols: int,
                    k_hi: int, *, triangle: bool = False, width: int = 0,
                    upper: str | None = None, k_offset: int = 0, whole: bool = False):
    """The plan and workspace arguments of the tensor-core tile's entry
    points (B, C, D, F, G, H, J, K and L), after `_check_tma` on the
    operands the kernel reads through TMA (a, and b unless F generates it:
    None).  A plan with no partials takes no workspace.  Returns (args,
    keep-alive tensors)."""
    _check_tma(what, *(t for t in (a, b) if t is not None))
    units, finish, n_slots = _tc_plan_on(a.device, rows, cols, k_hi, triangle, width, upper,
                                         k_offset, whole)
    if not n_slots:
        return (units.data_ptr(), units.shape[0], finish.data_ptr(), finish.shape[0], None), ()
    ws = torch.empty((n_slots, TC_TILE, TC_TILE), dtype=a.dtype, device=a.device)
    return ((units.data_ptr(), units.shape[0], finish.data_ptr(), finish.shape[0],
             ws.data_ptr()), (ws,))


def panel_update_reference(m: torch.Tensor, j0: int, block: int) -> torch.Tensor:
    """Plain twin of Kernel B (in place on m; returns m)."""
    if j0 > 0:
        m[j0:, j0:j0 + block] -= m[j0:, :j0] @ m[j0:j0 + block, :j0].T
    return m


def panel_update(m: torch.Tensor, j0: int, block: int) -> torch.Tensor:
    """Trailing update of column panel [j0, j0+block) from the finished
    columns < j0, in place on m for rows >= j0 (rows above j0 untouched)."""
    n = _check_square("panel_update", m)
    if not 0 <= j0 < n or block <= 0 or j0 + block > n:
        raise ValueError(f"panel_update: panel [{j0}, {j0 + block}) outside {n}")
    if not _build.takes_kernel("panel_update", m):
        return panel_update_reference(m, j0, block)
    _build.check_cuda_args("panel_update", m)
    if j0 == 0:  # no finished columns: nothing to subtract, nothing launched
        return m
    # G in place: a = m[j0:, :j0], b = m[j0:j0+B, :j0], S = out =
    # m[j0:, j0:j0+B]; it reads columns < j0 and writes [j0, j0+B).
    plan, _keep = _tc_launch_args("panel_update", m[j0:, :j0], m[j0:j0 + block, :j0], n - j0,
                                  block, j0)
    _build.call("gpis_panel_update", m, m.data_ptr(), n, j0, block, *plan)
    _build.LAUNCHES["panel_update"] += 1
    return m


def row_update_reference(w: torch.Tensor, l_row: torch.Tensor, j0: int) -> torch.Tensor:
    """Plain twin of Kernel C."""
    out = torch.zeros_like(l_row)
    if j0 > 0:
        out[:, :j0] = l_row[:, :j0] @ w[:j0, :j0]
    return out


def row_update(w: torch.Tensor, l_row: torch.Tensor, j0: int) -> torch.Tensor:
    """L_row[:, :j0] @ W[:j0, :] for a W whose rows < j0 are finished and
    lower-triangular; columns >= j0 of the (B, n) result are zero.  l_row
    may be a row band of w itself (the in-place TRSM)."""
    n = _check_square("row_update", w)
    if l_row.ndim != 2 or l_row.shape[1] != n:
        raise ValueError(f"row_update: l_row must be (B, {n}), got {tuple(l_row.shape)}")
    if not 0 <= j0 <= n:
        raise ValueError(f"row_update: j0={j0} outside [0, {n}]")
    if not _build.takes_kernel("row_update", w):
        return row_update_reference(w, l_row, j0)
    _build.check_cuda_args("row_update", w, l_row)
    if j0 == 0:  # W[:0] is empty: the update is zero, nothing launched
        return torch.zeros_like(l_row)
    bw = l_row.shape[0]
    out = torch.empty_like(l_row)
    plan, _keep = _tc_launch_args("row_update", l_row, w, bw, j0, j0, triangle=True, width=n)
    _build.call("gpis_row_update", w, l_row.data_ptr(), w.data_ptr(), n, j0, bw,
                out.data_ptr(), *plan)
    _build.LAUNCHES["row_update"] += 1
    return out


def gemm_nt_masked_reference(a, b, s, k0: int) -> torch.Tensor:
    """Plain twin of Kernel G."""
    return s - a[:, :k0] @ b[:, :k0].T


def gemm_nt_masked(a: torch.Tensor, b: torch.Tensor, s: torch.Tensor, k0: int) -> torch.Tensor:
    """S - A[:, :k0] @ B[:, :k0]^T as a new (R, P) tensor, for a (R, >= k0),
    b (P, >= k0) and s (R, P); each may be a strided row-major view (a
    stripe of s may lie inside a itself)."""
    r, p = s.shape
    if a.shape[0] != r or b.shape[0] != p or not 0 <= k0 <= min(a.shape[1], b.shape[1]):
        raise ValueError(f"gemm_nt_masked: a {tuple(a.shape)}, b {tuple(b.shape)}, "
                         f"s {tuple(s.shape)}, k0={k0} do not agree")
    if not _build.takes_kernel("gemm_nt_masked", s):
        return gemm_nt_masked_reference(a, b, s, k0)
    _build.check_cuda_rows("gemm_nt_masked", a, b, s)
    out = torch.empty((r, p), dtype=s.dtype, device=s.device)
    if r == 0 or p == 0:
        return out
    plan, _keep = _tc_launch_args("gemm_nt_masked", a, b, r, p, int(k0))
    _build.call("gpis_gemm_nt_masked", s, a.data_ptr(), a.stride(0), r, b.data_ptr(), b.stride(0),
                p, s.data_ptr(), s.stride(0), out.data_ptr(), p, int(k0), *plan)
    _build.LAUNCHES["gemm_nt_masked"] += 1
    return out


def gemm_nn_acc_masked_reference(u, a, b, w: int) -> torch.Tensor:
    """Plain twin of Kernel H (in place on u; returns u)."""
    u[:, :w] += a @ b[:, :w]
    return u


def gemm_nn_acc_masked(u: torch.Tensor, a: torch.Tensor, b: torch.Tensor, w: int) -> torch.Tensor:
    """U[:, :w] += A @ B[:, :w] in place (columns >= w untouched); returns u.
    u (R, >= w), a (R, K), b (K, >= w), each a row-major view.  u and b may
    be row ranges of one buffer, provided b's rows are not u's."""
    r, k = a.shape
    if u.shape[0] != r or b.shape[0] != k or not 0 <= w <= min(u.shape[1], b.shape[1]):
        raise ValueError(f"gemm_nn_acc_masked: u {tuple(u.shape)}, a {tuple(a.shape)}, "
                         f"b {tuple(b.shape)}, w={w} do not agree")
    if not _build.takes_kernel("gemm_nn_acc_masked", u):
        return gemm_nn_acc_masked_reference(u, a, b, w)
    _build.check_cuda_rows("gemm_nn_acc_masked", u, a, b)
    if r == 0 or k == 0 or w == 0:  # nothing to add, nothing launched
        return u
    plan, _keep = _tc_launch_args("gemm_nn_acc_masked", a, b, r, int(w), k)
    _build.call("gpis_gemm_nn_acc_masked", u, a.data_ptr(), a.stride(0), r, b.data_ptr(),
                b.stride(0), k, u.data_ptr(), u.stride(0), int(w), *plan)
    _build.LAUNCHES["gemm_nn_acc_masked"] += 1
    return u


def stripe_write_reference(dst, blk, c0: int) -> torch.Tensor:
    """Plain twin of Kernel I (in place on dst; returns dst)."""
    dst[:, c0:c0 + blk.shape[1]] = blk
    return dst


def stripe_write(dst: torch.Tensor, blk: torch.Tensor, c0: int) -> torch.Tensor:
    """dst[:, c0:c0+W] = blk in place for blk (R, W); returns dst."""
    r, w = blk.shape
    if dst.shape[0] != r or not 0 <= c0 <= dst.shape[1] - w:
        raise ValueError(f"stripe_write: a ({r}, {w}) stripe at column {c0} does not fit "
                         f"{tuple(dst.shape)}")
    if dst.device.type == "cpu":
        return stripe_write_reference(dst, blk, c0)
    _build.check_cuda_rows("stripe_write", dst, blk)
    if r == 0 or w == 0:
        return dst
    _build.call("gpis_stripe_write", dst, dst.data_ptr(), dst.stride(0), blk.data_ptr(),
                blk.stride(0), r, w, int(c0))
    _build.LAUNCHES["stripe_write"] += 1
    return dst


def panel_scale_reference(acc, v) -> torch.Tensor:
    """Plain twin of Kernel J."""
    return acc @ v.T


def panel_scale(acc: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """acc @ v^T as a new (R, B) tensor, for acc (R, B) a row-major view and
    v (B, B) LOWER-triangular (the kernel skips its zero upper half): the
    tensor-core tile's NT layout, each 128-column tile over k < its last
    column + 1 (`_tc_plan` upper "cols")."""
    r, b = acc.shape
    if v.shape != (b, b):
        raise ValueError(f"panel_scale: acc {tuple(acc.shape)} and v {tuple(v.shape)} do not agree")
    if not _build.takes_kernel("panel_scale", acc):
        return panel_scale_reference(acc, v)
    _build.check_cuda_rows("panel_scale", acc, v)
    out = torch.empty((r, b), dtype=acc.dtype, device=acc.device)
    if r == 0 or b == 0:
        return out
    plan, _keep = _tc_launch_args("panel_scale", acc, v, r, b, b, upper="cols")
    _build.call("gpis_panel_scale", acc, acc.data_ptr(), acc.stride(0), r, v.data_ptr(),
                v.stride(0), b, out.data_ptr(), b, *plan)
    _build.LAUNCHES["panel_scale"] += 1
    return out


def row_scale_reference(v, rhs) -> torch.Tensor:
    """Plain twin of Kernel K."""
    return v @ rhs


def row_scale(v: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """v @ rhs as a new (B, N) tensor, for v (B, B) LOWER-triangular and
    rhs (B, N) a row-major view: the tensor-core tile's NN layout, each
    128-row tile over k < its last row + 1 (`_tc_plan` upper "rows")."""
    b, n = rhs.shape
    if v.shape != (b, b):
        raise ValueError(f"row_scale: v {tuple(v.shape)} and rhs {tuple(rhs.shape)} do not agree")
    if not _build.takes_kernel("row_scale", rhs):
        return row_scale_reference(v, rhs)
    _build.check_cuda_rows("row_scale", v, rhs)
    out = torch.empty((b, n), dtype=rhs.dtype, device=rhs.device)
    if b == 0 or n == 0:
        return out
    plan, _keep = _tc_launch_args("row_scale", v, rhs, b, n, b, upper="rows")
    _build.call("gpis_row_scale", rhs, v.data_ptr(), v.stride(0), b, rhs.data_ptr(),
                rhs.stride(0), n, out.data_ptr(), n, *plan)
    _build.LAUNCHES["row_scale"] += 1
    return out


def _trail_ranges(r: int, c: int, block: int, j0: int, row0: int) -> tuple[int, int]:
    """Kernel L's live region: local rows from the first whose global index
    is >= j0 + block, columns below j0 + block.  The one place that computes
    it: the twin and both of the kernel's entry points take it from here."""
    return min(max(j0 + block - row0, 0), r), min(j0 + block, c)


def band_trail_reference(s, l_col, wj, j0: int, row0: int) -> torch.Tensor:
    """Plain twin of Kernel L (in place on s; returns s): the masked product
    on the live rows and columns, as one library call."""
    r, c = s.shape
    r_b, w = _trail_ranges(r, c, wj.shape[0], j0, row0)
    if r_b < r:
        s[r_b:, :w].addmm_(l_col[r_b:], wj[:, :w], alpha=-1)
    return s


def band_trail(s: torch.Tensor, l_col: torch.Tensor, wj: torch.Tensor, j0: int,
               row0: int) -> torch.Tensor:
    """S -= (l_col masked to global rows >= j0 + B) @ wj in place; returns s.
    s (R, C) is a row band of S at global rows [row0, row0 + R), l_col
    (R, B) the band's column panel j of L, wj (B, C) the W row panel j,
    zero at columns >= j0 + B (the update leaves those columns alone).
    Each is a row-major view.  The tensor-core tile's NN layout with
    SUB_FROM in place on the live block (`_trail_ranges`), planned over its
    rows x columns, k < B."""
    r, c = s.shape
    b = l_col.shape[1]
    if l_col.shape[0] != r or wj.shape != (b, c) or j0 < 0 or row0 < 0:
        raise ValueError(f"band_trail: s {tuple(s.shape)}, l_col {tuple(l_col.shape)}, "
                         f"wj {tuple(wj.shape)}, j0={j0}, row0={row0} do not agree")
    if not _build.takes_kernel("band_trail", s):
        return band_trail_reference(s, l_col, wj, j0, row0)
    _build.check_cuda_rows("band_trail", s, l_col, wj)
    r_b, w = _trail_ranges(r, c, b, int(j0), int(row0))
    if r_b >= r or w <= 0 or b == 0:  # no live row: nothing launched
        return s
    live_s, live_l = s[r_b:], l_col[r_b:]
    plan, _keep = _tc_launch_args("band_trail", live_l, wj, r - r_b, w, b)
    _build.call("gpis_band_trail", s, live_s.data_ptr(), s.stride(0), live_l.data_ptr(),
                l_col.stride(0), wj.data_ptr(), wj.stride(0), r - r_b, w, b, *plan)
    _build.LAUNCHES["band_trail"] += 1
    return s


def _panel_solve(panel_solve: str | None) -> str:
    ps = PANEL_SOLVE if panel_solve is None else panel_solve
    if ps not in ("xla", "inv"):
        raise ValueError(f"panel_solve must be 'xla' or 'inv', got {ps!r}")
    return ps


def _tri_small_inv(ld: torch.Tensor) -> torch.Tensor:
    """Ljj^{-1} of the (B, B) diagonal block by substitution against I (the
    JAX package's `_tri_small_inv`); lower-triangular, row-major (the
    library returns it column-major on CUDA, which J and K do not take)."""
    eye = torch.eye(ld.shape[0], dtype=ld.dtype, device=ld.device)
    return torch.linalg.solve_triangular(ld, eye, upper=False).contiguous()


def _potrf(d: torch.Tensor):
    """Lower factor of a B x B block and whether it is positive definite."""
    ld, info = torch.linalg.cholesky_ex(d)
    with profiling.wait("potrf"):
        return ld, int(info) == 0


def blocked_cholesky(a: torch.Tensor, block: int = 256, *,
                     panel_solve: str | None = None) -> torch.Tensor:
    """Left-looking blocked Cholesky, IN PLACE: a is overwritten by its lower
    factor L (strict upper triangle zero) and returned -- peak memory is the
    one matrix.  A non-positive-definite panel leaves a NaN diagonal, the
    signal the jitter ladder checks (`jnp.linalg.cholesky` returns NaN where
    `torch.linalg.cholesky` would raise).  panel_solve (module note): the
    panel below each diagonal block by substitution, or ("inv") as one
    product with Ljj^{-1} through Kernel J."""
    n = _check_square("blocked_cholesky", a)
    if n % block:
        raise ValueError(f"matrix size {n} must be a multiple of block {block}")
    inv = _panel_solve(panel_solve) == "inv"
    for j0 in range(0, n, block):
        j1 = j0 + block
        profiling.count("chol.panels")
        panel_update(a, j0, block)
        ld, ok = _potrf(a[j0:j1, j0:j1])
        if not ok:
            a.diagonal().fill_(float("nan"))
            return a
        if j1 < n and inv:
            a[j1:, j0:j1] = panel_scale(a[j1:, j0:j1], _tri_small_inv(ld))
        elif j1 < n:
            # X ld^T = A_below  ->  X = A_below ld^{-T}
            a[j1:, j0:j1] = torch.linalg.solve_triangular(ld.T, a[j1:, j0:j1], upper=True,
                                                          left=False)
        a[j0:j1, j0:j1] = ld
        a[:j0, j0:j1] = 0.0
    return a


def blocked_linv(l: torch.Tensor, block: int = 256, *, inplace: bool = False,
                 panel_solve: str | None = None) -> torch.Tensor:
    """W = L^{-1} by the left-looking blocked TRSM

        for block row j:  W[j, :] = Ljj^{-1} (I[j, :] - L[j, :j0] W[:j0, :])

    whose row update is Kernel C, and whose Ljj^{-1} is applied by
    substitution or ("inv") as one product through Kernel K.  W comes out
    lower-triangular.  inplace=True overwrites L with W row band by row band
    (step j reads L's row panel j and the finished W rows < j0 from the
    same buffer), so peak memory is one matrix; the caller loses L."""
    n = _check_square("blocked_linv", l)
    if n % block:
        raise ValueError(f"matrix size {n} must be a multiple of block {block}")
    inv = _panel_solve(panel_solve) == "inv"
    w = l if inplace else torch.zeros_like(l)
    for j0 in range(0, n, block):
        j1 = j0 + block
        l_row = l[j0:j1]  # L's row panel (still L in the in-place buffer)
        upd = row_update(w, l_row, j0)
        rhs = -upd[:, :j1]
        rhs[:, j0:j1] += torch.eye(block, dtype=l.dtype, device=l.device)
        if inv:
            wj = row_scale(_tri_small_inv(l_row[:, j0:j1]), rhs)
        else:
            wj = torch.linalg.solve_triangular(l_row[:, j0:j1], rhs, upper=False)
        w[j0:j1, :j1] = wj
        w[j0:j1, j1:] = 0.0
    return w
