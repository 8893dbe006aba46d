"""Greedy track-id assignment on device tensors (counterpart of
``slotvps_tpu/tracking_jax.py``; the name differs because this module
holds no JAX).

The host loop of :class:`slotvps_tpu_torch.tracking.TrackState` (reference
mmdet/models/detectors/vps_temporal_slots.py:361-406) assigns ids one
instance at a time.  Here the order-dependent rules are closed-form rank and
argmax computations over fixed-capacity padded tensors, so a frame's ids
come out of a few tensor ops with no host sync (``VideoScanner`` in
``inference.py`` reads them back once per clip):

  * row decision = argmax of log-softmax over [new | pool] columns,
  * all rows claiming the same pool id: the highest likelihood wins (ties:
    the earliest row — the reference's strict ``>`` update),
  * first-pass new objects (column 0) get ids ``pool_size + rank`` in row
    order; demoted losers get ids after all first-pass news, in row order,
  * winners overwrite their pool embedding; news append in id order.

Fixed capacity: the pool holds ``capacity`` embeddings; appends past
capacity are dropped and never overwrite slot ``capacity - 1`` (the
reference eval caps track growth anyway,
tools/dataset/cityscapes_vps.py:220-244 ``max_oid=100``).

``started`` is a host bool that the caller owns (the scanner knows which
frame starts a clip), so :func:`track_step` picks its branch without a
device round trip and computes only that branch.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

_NEG = -1e30


class PoolState(NamedTuple):
    """Fixed-capacity track pool, carried from frame to frame."""

    embeddings: torch.Tensor   # [P, D] f32
    size: torch.Tensor         # [] int32 on the pool's device: live ids
    started: bool              # the pool was started in this video


def init_pool(capacity: int, dim: int, device="cuda") -> PoolState:
    return PoolState(
        embeddings=torch.zeros((capacity, dim), dtype=torch.float32,
                               device=device),
        size=torch.zeros((), dtype=torch.int32, device=device),
        started=False)


def _set_rows(emb: torch.Tensor, slot: torch.Tensor,
              rows: torch.Tensor) -> torch.Tensor:
    """A copy of ``emb`` [P, D] with row ``slot[i]`` set to ``rows[i]``;
    slots equal to P are dropped (JAX's ``.at[slot].set(mode="drop")``)."""
    p = emb.shape[0]
    out = torch.cat([emb, emb.new_zeros((1, emb.shape[1]))])
    out[slot] = rows.to(out.dtype)
    return out[:p]


def start_pool(pool: PoolState, cur_emb: torch.Tensor,
               cur_valid: torch.Tensor) -> Tuple[torch.Tensor, PoolState]:
    """First frame: ids are 0..N-1 in row order among the valid rows
    (reference :332-339).  cur_emb: [K, D]; cur_valid: [K] bool.  Returns
    (ids [K] int32, -1 on invalid rows; the started pool)."""
    p = pool.embeddings.shape[0]
    rank = torch.cumsum(cur_valid.to(torch.int32), 0) - 1
    ids = torch.where(cur_valid, rank, -1)
    slot = torch.where(cur_valid & (ids < p), ids, p).long()
    emb = _set_rows(pool.embeddings, slot, cur_emb)
    n = torch.clamp_max(cur_valid.sum(), p).to(torch.int32)
    return ids.to(torch.int32), PoolState(emb, n, True)


def update_pool(pool: PoolState, match_score: torch.Tensor,
                cur_emb: torch.Tensor, cur_valid: torch.Tensor
                ) -> Tuple[torch.Tensor, PoolState]:
    """One tracking step (reference :345-409 / ``TrackState.update``).

    match_score: [K, P+1] — column 0 = new object, column j+1 = pool id j
    (pool columns past the pool's size and invalid rows are masked here).
    Returns (ids [K] int32, the new pool)."""
    k, pcols = match_score.shape
    p = pcols - 1
    dev = match_score.device
    m = pool.size
    col_valid = torch.cat([torch.ones((1,), dtype=torch.bool, device=dev),
                           torch.arange(p, device=dev) < m])
    score = torch.where(col_valid[None, :], match_score, _NEG)
    logprob = torch.log_softmax(score, dim=1)
    likelihood = logprob.amax(dim=1)
    match_ids = torch.argmax(logprob, dim=1)     # first index on ties
    match_ids = torch.where(cur_valid, match_ids, 0)

    # winner per pool id: highest likelihood among claimers, earliest row
    # on ties (strict > in the reference loop)
    cols = torch.arange(1, p + 1, device=dev)
    claims = (match_ids[:, None] == cols[None, :]) & cur_valid[:, None]
    claim_score = torch.where(claims, likelihood[:, None], _NEG)
    winner_row = torch.argmax(claim_score, dim=0)                 # [P]
    has_winner = claims[winner_row, torch.arange(p, device=dev)]  # [P]
    is_winner = torch.zeros((k + 1,), dtype=torch.bool, device=dev)
    is_winner[torch.where(has_winner, winner_row, k)] = True
    is_winner = is_winner[:k]

    is_new_first = cur_valid & (match_ids == 0)
    is_loser = cur_valid & (match_ids > 0) & ~is_winner
    n_first = is_new_first.sum()
    rank_first = torch.cumsum(is_new_first.long(), 0) - 1
    rank_loser = torch.cumsum(is_loser.long(), 0) - 1

    ids = torch.where(is_winner, match_ids - 1, -1)
    ids = torch.where(is_new_first, m + rank_first, ids)
    ids = torch.where(is_loser, m + n_first + rank_loser, ids)
    ids = torch.where(cur_valid, ids, -1)

    # winners replace, news append; an append past capacity (slot P) is
    # dropped, so it never clobbers slot P-1's winner
    slot = torch.where(cur_valid & (ids >= 0) & (ids < p), ids, p).long()
    emb = _set_rows(pool.embeddings, slot, cur_emb)
    new_size = torch.clamp_max(m + n_first + is_loser.sum(), p) \
        .to(torch.int32)
    return ids.to(torch.int32), PoolState(emb, new_size, pool.started)


def track_step(pool: PoolState, match_score: torch.Tensor,
               cur_emb: torch.Tensor, cur_valid: torch.Tensor
               ) -> Tuple[torch.Tensor, PoolState]:
    """:func:`start_pool` on the first frame of a video, :func:`update_pool`
    after; the branch is the host bool ``pool.started``."""
    if pool.started:
        return update_pool(pool, match_score, cur_emb, cur_valid)
    return start_pool(pool, cur_emb, cur_valid)
