"""Data pipeline: synthetic token sources, sequence packing, and
DySkew-balanced sharding across data-parallel workers.

Variable-length documents make per-shard compute skewed (cost grows with
packed-sequence attention length²); the pipeline routes packed sequences
to DP shards through the generic ``AdaptiveLink`` — the batch-level
instantiation of the paper's technique (DESIGN.md §3.5).  A background
prefetch thread overlaps host batch assembly with device compute.  The
link runs on the pipeline's ``device`` (``None`` = the GPU); on a GPU the
prefetch thread issues its link step on a CUDA stream of its own, so that
reading the plan back waits for the link's kernels only, not for the
training step queued on the default stream.

Multi-tenant mixing: with ``DataConfig.tenant_weights`` set, each tenant
gets its own deterministic document stream and the pipeline interleaves
them by classic deficit round robin (`FairShareAdmission.pick_next` from
`repro_torch.core.admission`, the same planner the simulator and serving engine
use), with document token counts as the DRR cost — so over time each
tenant's share of emitted tokens converges to its weight.
"""

from __future__ import annotations

import contextlib
import dataclasses
import queue
import threading
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch._device import DeviceLike
from repro_torch.core import (
    AdaptiveLink,
    AdaptiveLinkConfig,
    BatchAdmission,
    DySkewConfig,
    Policy,
)
from repro_torch.core.admission import FairShareAdmission, FairShareConfig
from repro_torch.core.policy import PolicyContext, StrategyConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    # Lengths ~ clipped lognormal; heavier tail = more packing skew.
    doc_len_mean: float = 600.0
    doc_len_sigma: float = 1.0
    seed: int = 0
    pack: bool = True
    dyskew_balance: bool = True
    num_shards: int = 1
    prefetch: int = 2
    # Shard-placement policy: any name registered in `repro_torch.core.policy`
    # (unknown names raise ValueError at pipeline construction).  The
    # default 'dyskew' keeps the AdaptiveLink balancing path; any other
    # policy assigns sequences through its `assign` placement over the
    # quadratic per-sequence cost model instead.
    placement: str = "dyskew"
    # Weighted fair-share mixing across tenant document streams (None =
    # single-tenant).  Tenant i's share of emitted tokens converges to
    # tenant_weights[i] / sum(tenant_weights).
    tenant_weights: Optional[Tuple[float, ...]] = None


class _TenantDoc(np.ndarray):
    """ndarray view carrying its owning tenant index (``tenant`` attr).

    Lets the packer credit `DataPipeline.tenant_tokens` when a document
    is actually placed — crediting at draw time over-counted whenever a
    document fit no sequence and was carried (previously: dropped)."""

    tenant: int


class SyntheticDocs:
    """Deterministic document stream (id, tokens)."""

    def __init__(self, cfg: DataConfig, seed_offset: int = 0):
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed + seed_offset)

    def __iter__(self) -> Iterator[np.ndarray]:
        import math

        mu = math.log(self.cfg.doc_len_mean) - 0.5 * self.cfg.doc_len_sigma**2
        while True:
            n = int(np.clip(
                self.rng.lognormal(mu, self.cfg.doc_len_sigma),
                16, self.cfg.seq_len,
            ))
            yield self.rng.integers(
                1, self.cfg.vocab_size, size=n, dtype=np.int32
            )


def pack_documents(
    docs: Iterator[np.ndarray],
    seq_len: int,
    count: int,
    carry: Optional[List[np.ndarray]] = None,
    on_pack: Optional[Callable[[np.ndarray], None]] = None,
) -> List[np.ndarray]:
    """Greedy first-fit packing of documents into `count` sequences.

    ``carry`` (when given) is the cross-batch leftover buffer: documents
    in it are offered FIRST, and a drawn document that fits no open
    sequence is appended to it for the next batch instead of being
    silently dropped (the drop both lost data and broke the tenant token
    accounting — the mixer had already credited the tokens).
    ``on_pack`` fires once per document actually placed, which is where
    per-tenant token accounting now lives."""
    seqs: List[List[np.ndarray]] = [[] for _ in range(count)]
    fill = np.zeros(count, np.int64)
    offer: List[np.ndarray] = list(carry) if carry else []
    if carry is not None:
        carry.clear()
    oi = 0
    for i in range(count * 4 + len(offer)):  # bounded attempts
        if fill.min() >= seq_len:
            break
        if oi < len(offer):
            doc = offer[oi]
            oi += 1
        else:
            try:
                doc = next(docs)
            except StopIteration:
                # Finite stream exhausted (pipeline streams are infinite;
                # direct callers may not be): pack what we have.
                break
        # first shard with room
        order = np.argsort(fill)
        for s in order:
            if fill[s] + len(doc) <= seq_len:
                seqs[s].append(doc)
                fill[s] += len(doc)
                if on_pack is not None:
                    on_pack(doc)
                break
        else:
            # Fits nowhere this batch: keep it for the next one — unless
            # it can never fit ANY sequence (len > seq_len), which would
            # carry it forever; such a doc is structurally unpackable
            # and is discarded uncounted (the pipeline's own streams
            # clip to seq_len, so this only guards direct callers).
            if carry is not None and len(doc) <= seq_len:
                carry.append(doc)
    if carry is not None:
        carry.extend(offer[oi:])
    out = []
    for s in range(count):
        toks = (np.concatenate(seqs[s]) if seqs[s]
                else np.zeros(0, np.int32))[:seq_len]
        pad = np.zeros(seq_len - len(toks), np.int32)
        out.append(np.concatenate([toks, pad]))
    return out


class DataPipeline:
    """Batches of packed sequences, DySkew-balanced across DP shards.

    The per-sequence cost model is quadratic in real (non-pad) length —
    the attention cost that actually skews step time across shards.
    """

    def __init__(self, cfg: DataConfig, device: DeviceLike = None):
        self.cfg = cfg
        # Cross-batch leftover buffer: documents that fit no sequence of
        # the current batch are carried to the next one, never dropped.
        self._carry: List[np.ndarray] = []
        if cfg.tenant_weights:
            # Per-tenant token accounting for observability/tests —
            # credited when a document is actually PACKED (see
            # `_on_pack`), not when the mixer draws it, so the counters
            # always equal the tokens that really reached batches.
            self.tenant_tokens = np.zeros(len(cfg.tenant_weights), np.int64)
            self.docs = iter(self._mixed_docs())
        else:
            self.docs = iter(SyntheticDocs(cfg))
        # Resolve the shard-placement policy through the shared registry
        # (ValueError on unknown names — construction-time, not deep in
        # a prefetch thread).  `uses_link` decides whether the
        # AdaptiveLink balancing path below is active.
        self.policy = StrategyConfig(kind=cfg.placement).make_policy(
            PolicyContext(num_workers=max(cfg.num_shards, 1))
        )
        self.link = AdaptiveLink(AdaptiveLinkConfig(
            dyskew=DySkewConfig(policy=Policy.EAGER_SNOWPARK),
            num_instances=max(cfg.num_shards, 1),
        ), device=device)
        self.link_state = self.link.init_state()
        # The link's own stream on a GPU (see the module docstring); it
        # starts after the initial state is written on the current stream.
        self._stream = None
        if self.link.device.type == "cuda":
            self._stream = torch.cuda.Stream(self.link.device)
            self._stream.wait_stream(torch.cuda.current_stream(self.link.device))
        # Shared admission planner (same guards as the simulator / serving):
        # the Row Size Model keeps pathological huge-sequence batches local
        # instead of paying the reshard.
        self.admission = BatchAdmission(self.link.config.dyskew)
        self._q: "queue.Queue" = queue.Queue(maxsize=cfg.prefetch)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------- #

    def _mixed_docs(self) -> Iterator[np.ndarray]:
        """Interleave per-tenant document streams by deficit round robin:
        each pick is charged the document's token count, so token share
        (not just document count) follows the weights.  Documents are
        tagged with their owning tenant (`_TenantDoc` view); the token
        credit happens at PACK time via `_on_pack`, so a document parked
        in the carry buffer is not counted until it really lands in a
        batch."""
        cfg = self.cfg
        weights = list(cfg.tenant_weights)
        planner = FairShareAdmission(
            weights,
            FairShareConfig(quantum_rows=float(cfg.seq_len)),
        )
        streams = [
            iter(SyntheticDocs(cfg, seed_offset=1 + 7919 * i))
            for i in range(len(weights))
        ]
        pending = [next(s) for s in streams]
        while True:
            q = planner.pick_next([float(len(d)) for d in pending])
            doc = pending[q]
            pending[q] = next(streams[q])
            tagged = doc.view(_TenantDoc)
            tagged.tenant = q
            yield tagged

    def _on_pack(self, doc: np.ndarray) -> None:
        """Per-document pack callback: credit the owning tenant's token
        counter (docs from `_mixed_docs` carry a tenant tag)."""
        q = getattr(doc, "tenant", None)
        if q is not None:
            self.tenant_tokens[q] += len(doc)

    def _assemble(self) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        seqs = pack_documents(
            self.docs, cfg.seq_len, cfg.global_batch,
            carry=self._carry,
            on_pack=self._on_pack if cfg.tenant_weights else None,
        )
        tokens = np.stack(seqs)
        if cfg.dyskew_balance and cfg.num_shards > 1:
            lens = (tokens != 0).sum(axis=1).astype(np.float32)
            balance = not self.admission.density_guard_blocks(
                num_rows=cfg.global_batch // max(cfg.num_shards, 1),
                bytes_per_row=float(lens.sum()) * 4.0
                / max(cfg.global_batch, 1),
            )
        else:
            balance = False
        if balance:
            costs = lens**2 / float(cfg.seq_len) ** 2
            sizes = lens * 4.0
            producer = (
                np.arange(cfg.global_batch) * cfg.num_shards
                // cfg.global_batch
            ).astype(np.int32)
            if self.policy.uses_link:
                dest = self._link_dest(costs, sizes, producer)
            else:
                # Registry policies place through the shared `assign`
                # seam: per-sequence quadratic costs, producer = the
                # shard the row-block layout would give the sequence.
                dest = self.policy.assign(
                    costs, producer, max(cfg.num_shards, 1)
                )
            # Reorder sequences so shard s receives contiguous rows: the
            # device layout maps row-blocks to DP shards.
            order = np.argsort(dest, kind="stable")
            tokens = tokens[order]
        targets = np.concatenate(
            [tokens[:, 1:], np.zeros((len(tokens), 1), np.int32)], axis=1
        )
        targets = np.where(targets == 0, -1, targets)  # mask pads
        return {"tokens": tokens, "targets": targets}

    def _link_dest(self, costs: np.ndarray, sizes: np.ndarray,
                   producer: np.ndarray) -> np.ndarray:
        """One link step over the batch's sequences; the plan's destinations
        read back to the host."""
        dev = self.link.device
        on_stream = torch.cuda.stream(self._stream) if self._stream is not None else contextlib.nullcontext()
        with on_stream:
            self.link_state, plan = self.link.step(
                self.link_state,
                torch.from_numpy(costs).to(dev), torch.from_numpy(sizes).to(dev),
                torch.from_numpy(producer).to(dev),
            )
            return plan.dest.cpu().numpy()

    def _worker(self):
        while not self._stop.is_set():
            batch = self._assemble()
            while not self._stop.is_set():
                try:
                    self._q.put(batch, timeout=0.1)
                    break
                except queue.Full:
                    continue

    def start(self) -> "DataPipeline":
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            # Join: a daemon thread mid-CUDA-call at interpreter exit
            # must not outlive the process's CUDA context.
            self._thread.join(timeout=2.0)
            self._thread = None

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        if self._thread is None:
            return self._assemble()
        return self._q.get()
