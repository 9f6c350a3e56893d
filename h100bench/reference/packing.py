"""Packing documents into training rows, worked out again.

The rule the configuration's data pipeline states (``DataPipeline`` in
``src/repro_torch/data/pipeline.py`` at commit a36dd41, written here
plainly): each batch offers first the documents carried over from the last
one, then draws; a document goes to the open row with the least tokens
where it fits, else it is carried to the next batch; a row is padded with
id 0, and a target is the next token, -1 at a pad.  At most 4 draws a row
a batch.  The pipeline may then reorder the rows over its shards: which
row lands on which shard is its link's decision, so the reference holds the
program's rows to its own as a set and follows the program's order.
"""

from __future__ import annotations

from typing import Dict, Iterator, List

import numpy as np


class Packer:
    def __init__(self, docs: Iterator[np.ndarray], seq_len: int, rows: int):
        self.docs, self.seq_len, self.rows = docs, seq_len, rows
        self.carry: List[np.ndarray] = []

    def batch(self) -> np.ndarray:
        S, R = self.seq_len, self.rows
        rows: List[List[np.ndarray]] = [[] for _ in range(R)]
        fill = np.zeros(R, np.int64)
        offer, self.carry = self.carry, []
        taken = 0
        for _ in range(R * 4 + len(offer)):
            if fill.min() >= S:
                break
            if taken < len(offer):
                doc = offer[taken]
                taken += 1
            else:
                doc = next(self.docs)
            for r in np.argsort(fill):
                if fill[r] + len(doc) <= S:
                    rows[r].append(doc)
                    fill[r] += len(doc)
                    break
            else:
                if len(doc) <= S:
                    self.carry.append(doc)
        self.carry.extend(offer[taken:])
        out = np.zeros((R, S), np.int32)
        for r in range(R):
            if rows[r]:
                toks = np.concatenate(rows[r])[:S]
                out[r, :len(toks)] = toks
        return out


def targets_of(tokens: np.ndarray) -> np.ndarray:
    nxt = np.concatenate([tokens[:, 1:], np.zeros((len(tokens), 1), tokens.dtype)], axis=1)
    return np.where(nxt == 0, -1, nxt).astype(np.int32)


def rows_unmatched(program: np.ndarray, reference: np.ndarray) -> int:
    """Rows of ``program`` that are not rows of ``reference`` (as a
    multiset): 0 when the program's batch is the reference's, reordered."""
    want: Dict[bytes, int] = {}
    for r in reference:
        want[r.tobytes()] = want.get(r.tobytes(), 0) + 1
    bad = 0
    for r in program:
        key = r.tobytes()
        if want.get(key, 0) > 0:
            want[key] -= 1
        else:
            bad += 1
    return bad
