"""In-graph linear-sum-assignment (Hungarian matching) for the object field.

The reference hops to SciPy on the CPU *every training step*
(/root/reference/networks/evaluator.py:41-74: cost matrix on GPU -> .cpu().numpy() ->
scipy.optimize.linear_sum_assignment -> back), a device->host->device sync in the hot
loop. Here the assignment runs fully on-device inside jit: a Jonker-Volgenant
shortest-augmenting-path solver expressed with lax loops, whose inner Dijkstra step is
vectorized over columns. Cost matrices are tiny (ins_num^2 ≈ 32x32), so the whole solve
is microseconds of VPU work and the train step never leaves the chip.

The correctness bar is "same (optimal) assignment cost", not the same tie-breaking as
SciPy; ties can resolve differently, which is loss-equivalent (SURVEY.md §7 hard parts).

Rectangular (valid_rows x n) problems are handled by padding the remaining rows with a
constant cost: constant rows are column-indifferent, so the valid rows' assignment
remains optimal and padding rows absorb the leftover columns — exactly the reference's
"unmapped columns appended" semantics (evaluator.py:48-52), whose order never matters
downstream (only the *set* of unmatched columns is consumed, via a mean).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_INF = jnp.inf


def _augmenting_path_step(cost, u, v, row4col, col4row, cur_row):
    """One row of Jonker-Volgenant: Dijkstra to the nearest unassigned column,
    dual updates, then augment along the predecessor path."""
    n = cost.shape[0]
    ar = jnp.arange(n)

    # Both inner loops are iteration-bounded: Dijkstra scans at most n columns and the
    # augmenting walk has at most n edges. A non-finite cost (upstream NaN) could
    # otherwise stall the free-column search forever and hang the device; with the
    # bound, bad inputs degrade to a wrong-but-finite assignment.
    #
    # The whole solve is serialized while_loop latency; the bodies use masked
    # `where`/reduce over the full [n] vector instead of scatters (`at[].set`) and
    # dynamic gathers.
    def dij_cond(s):
        return (s[6] < 0) & (s[7] <= n)

    def dij_body(s):
        i, min_val, remaining, sr, shortest, path, _sink, it = s
        row_i = ar == i
        sr = sr | row_i
        cost_i = jnp.sum(jnp.where(row_i[:, None], cost, 0.0), axis=0)
        u_i = jnp.sum(jnp.where(row_i, u, 0.0))
        r = min_val + cost_i - u_i - v
        upd = (r < shortest) & remaining
        path = jnp.where(upd, i, path)
        shortest = jnp.where(upd, r, shortest)
        masked = jnp.where(remaining, shortest, _INF)
        j = jnp.argmin(masked)
        min_val = jnp.min(masked)
        r4c_j = jnp.sum(jnp.where(ar == j, row4col, 0))  # row4col[j]; -1 sums intact
        hit_free = r4c_j < 0
        sink = jnp.where(hit_free, j, -1)
        i = jnp.where(hit_free, i, r4c_j)
        remaining = remaining & (ar != j)
        return (i, min_val, remaining, sr, shortest, path, sink, it + 1)

    init = (
        cur_row,
        jnp.asarray(0.0, cost.dtype),
        jnp.ones((n,), bool),
        jnp.zeros((n,), bool),
        jnp.full((n,), _INF, cost.dtype),
        jnp.full((n,), -1, jnp.int32),
        jnp.asarray(-1, jnp.int32),
        jnp.asarray(0, jnp.int32),
    )
    _, min_val, remaining, sr, shortest, path, sink, _ = jax.lax.while_loop(dij_cond, dij_body, init)
    sink = jnp.maximum(sink, 0)  # bound hit (non-finite cost): pick col 0, stay well-formed

    # dual updates (scanned rows/cols only)
    u = u + jnp.where(ar == cur_row, min_val, 0.0)
    sr_other = sr & (ar != cur_row)
    # shortest[col4row] without a gather; rows with col4row=-1 match nothing and
    # read 0, but they are never in sr_other (only assigned rows get scanned)
    shortest_at_rowcol = jnp.sum(
        jnp.where(col4row[:, None] == ar[None, :], shortest[None, :], 0.0), axis=1)
    u = u + jnp.where(sr_other, min_val - shortest_at_rowcol, 0.0)
    scanned_cols = ~remaining
    v = v - jnp.where(scanned_cols, min_val - shortest, 0.0)

    # augment: walk predecessors from the sink back to cur_row (bounded, see above)
    def aug_cond(s):
        return (~s[3]) & (s[4] <= n)

    def aug_body(s):
        j, r4c, c4r, _done, it = s
        col_j = ar == j
        i = jnp.maximum(jnp.sum(jnp.where(col_j, path, 0)), 0)  # path[j]; -1 sums intact
        r4c = jnp.where(col_j, i, r4c)
        row_i = ar == i
        nj = jnp.sum(jnp.where(row_i, c4r, 0))
        c4r = jnp.where(row_i, j, c4r)
        return (nj, r4c, c4r, i == cur_row, it + 1)

    _, row4col, col4row, _, _ = jax.lax.while_loop(
        aug_cond, aug_body, (sink, row4col, col4row, jnp.asarray(False), jnp.asarray(0, jnp.int32))
    )
    return u, v, row4col, col4row


def linear_sum_assignment_jax(cost: jnp.ndarray) -> jnp.ndarray:
    """Solve the square assignment problem, minimizing total cost.

    cost: [n, n] finite float matrix. Returns col4row [n] int32: the column assigned
    to each row. jit-safe; O(n^3) with vectorized O(n) inner steps. This is exactly
    ``masked_assignment`` with every row valid (the solver setup lives there once).
    """
    return masked_assignment(cost, jnp.asarray(cost.shape[0], jnp.int32))


def masked_assignment(cost: jnp.ndarray, valid_rows: jnp.ndarray) -> jnp.ndarray:
    """Assignment for the first ``valid_rows`` rows of a square cost matrix.

    The augmenting-path loop runs only ``valid_rows`` times (dynamic trip count,
    static shapes) — exactly the reference's rectangular [valid, n] solve
    (evaluator.py:41-52). The solver is serialized lax.while_loop latency and a
    typical batch sees ~8 instances, so 33 -> valid outer iterations cuts the
    loop count ~4x.
    Rows >= valid_rows are column-indifferent padding: they take the leftover
    columns in index order, which matches the reference's "unmapped columns
    appended" semantics — only the *set* of unmatched columns is ever consumed
    downstream (via a mean), never their order.
    """
    n = cost.shape[0]
    ar = jnp.arange(n)
    cost = jax.lax.stop_gradient(jnp.asarray(cost, jnp.float32))
    cost = jnp.nan_to_num(cost, nan=1e9, posinf=1e9, neginf=-1e9)
    u = jnp.zeros((n,), cost.dtype)
    v = jnp.zeros((n,), cost.dtype)
    row4col = jnp.full((n,), -1, jnp.int32)
    col4row = jnp.full((n,), -1, jnp.int32)

    def body(cur_row, carry):
        return _augmenting_path_step(cost, *carry, cur_row)

    valid = jnp.clip(valid_rows.astype(jnp.int32), 0, n)
    _, _, row4col, col4row = jax.lax.fori_loop(0, valid, body,
                                               (u, v, row4col, col4row))

    # padding rows take the leftover columns in index order
    free_col = row4col < 0                                    # [n] bool
    rank = jnp.cumsum(free_col.astype(jnp.int32)) - 1         # rank among leftovers
    # col_for_rank[r] = column index of the r-th free column (out-of-range drops)
    col_for_rank = jnp.zeros((n,), jnp.int32).at[
        jnp.where(free_col, rank, n)].set(ar, mode="drop")
    pad_cols = col_for_rank[jnp.clip(ar - valid, 0, n - 1)]
    return jnp.where(ar < valid, col4row, pad_cols)
