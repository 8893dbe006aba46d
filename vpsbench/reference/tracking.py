"""Greedy cross-frame instance id assignment (host side).

Behavioral port of the reference's per-frame tracking update
(reference mmdet/models/detectors/vps_temporal_slots.py:332-409): take the
track-head match scores of the current frame's kept instances against the
previous-instance pool (plus a "new object" column 0), log-softmax per row,
then greedily assign — the best-scoring candidate wins a previous id,
losers and column-0 matches get fresh ids appended to the pool.  The pool
stores one embedding per object id and is *replaced* by the matching
instance's embedding each frame.

The pool covers ALL kept instances (stuff included) exactly like the
reference; only thing ids are exported downstream.

N and M are <= a few hundred, so this is pure numpy; the match-score matmul
itself runs on device (models/track_head.py).

Frozen copy of ``slotvps_tpu_torch/tracking.py`` at commit
86b90feb98325982c750f329cf213fa73d0ed5b3, for the
benchmark's plain reference: it imports nothing of the port.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


class TrackState:
    """Per-video pool of previous-instance embeddings."""

    def __init__(self):
        self.embeddings: Optional[np.ndarray] = None  # [M, D]

    def reset(self):
        self.embeddings = None

    def start(self, cur_embeddings: np.ndarray) -> np.ndarray:
        """First frame: ids are 0..N-1 (reference :332-339)."""
        self.embeddings = np.array(cur_embeddings, np.float32, copy=True)
        return np.arange(cur_embeddings.shape[0], dtype=np.int64)

    def update(self, match_score: np.ndarray,
               cur_embeddings: np.ndarray) -> np.ndarray:
        """match_score: [N, M+1] (col 0 = new object).  Returns obj ids [N].
        Mirrors reference :345-409."""
        assert self.embeddings is not None
        m = self.embeddings.shape[0]
        n = match_score.shape[0]
        assert match_score.shape == (n, m + 1)

        # log-softmax over candidates
        s = match_score - match_score.max(axis=1, keepdims=True)
        logprob = s - np.log(np.exp(s).sum(axis=1, keepdims=True))
        match_likelihood = logprob.max(axis=1)
        match_ids = logprob.argmax(axis=1).astype(np.int64)

        pool = list(self.embeddings)
        det_obj_ids = np.full((n,), -1, np.int64)
        best_match_scores = np.full((m,), -100.0)
        best_match_ids = np.full((m,), -1, np.int64)

        for idx in range(n):
            if match_ids[idx] == 0:
                det_obj_ids[idx] = len(pool)
                pool.append(cur_embeddings[idx])
            else:
                obj_id = match_ids[idx] - 1
                score = match_likelihood[idx]
                if score > best_match_scores[obj_id]:
                    det_obj_ids[idx] = obj_id
                    # a previous winner for this id is demoted (:382-383)
                    if best_match_ids[obj_id] >= 0:
                        det_obj_ids[best_match_ids[obj_id]] = -1
                    best_match_scores[obj_id] = score
                    best_match_ids[obj_id] = idx
                    pool[obj_id] = cur_embeddings[idx]

        for idx in range(n):
            if det_obj_ids[idx] < 0:
                det_obj_ids[idx] = len(pool)
                pool.append(cur_embeddings[idx])

        self.embeddings = np.stack(pool).astype(np.float32)
        return det_obj_ids
