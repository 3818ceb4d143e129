"""Serving engine: per-request prefill + continuous-batching greedy decode.

The port's ``repro.serving.engine``, with the same batching:

* requests enter a queue; the engine keeps up to ``max_batch`` live
  sequences;
* prefill runs one request at a time, into a cache of ``cache_len`` slots;
* each decode step stacks the live slots' caches on the batch axis (axis 1,
  under the leading period axis) and runs one ``model.decode``;
* greedy argmax; a sequence that hits its EOS or its token budget frees its
  slot, and the queue refills it.

Everything runs under ``torch.inference_mode()`` on the model's device.
The engine also keeps the host-clock seconds of every prefill and decode
step (each ends with the tokens read back to the host, so the device has
finished): ``prefill_s``, ``decode_step_s`` and ``decode_batch``.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.config import ArchConfig
from repro_torch.models.lm import CausalLM
from repro_torch.service.metrics import RequestTiming


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray              # [S] token ids
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    # latency accounting (same stamp shape as the reduct service's requests)
    timing: RequestTiming = dataclasses.field(default_factory=RequestTiming)
    # filled by the engine:
    output: Optional[List[int]] = None
    latency_s: float = 0.0


class ServingEngine:
    def __init__(self, cfg: ArchConfig, model: CausalLM, *, max_batch: int = 4,
                 cache_len: int = 128, greedy: bool = True, device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        if model.device.type != self.device.type:
            raise ValueError(f"the model lies on {model.device}, the engine serves on "
                             f"{self.device}")
        self.cfg = cfg
        self.model = model
        self.max_batch = max_batch
        self.cache_len = cache_len
        self.greedy = greedy
        self.prefill_s: List[float] = []
        self.decode_step_s: List[float] = []
        self.decode_batch: List[int] = []

    def _prefill_one(self, prompt: np.ndarray):
        toks = torch.as_tensor(np.asarray(prompt)[None], dtype=torch.int64, device=self.device)
        return self.model.prefill(toks, cache_len=self.cache_len)

    @torch.inference_mode()
    def serve(self, requests: List[Request]) -> List[Request]:
        """Run all requests to completion with continuous batching."""
        queue = collections.deque(requests)
        for req in queue:
            req.timing.mark_enqueue()
        # per-slot state: each slot keeps its own batch-1 cache; a decode
        # batch stacks them (a production engine would page the cache)
        live: List[Dict[str, Any]] = []

        def admit():
            while queue and len(live) < self.max_batch:
                req = queue.popleft()
                req.timing.mark_start()
                t0 = time.perf_counter()
                logits, cache, lengths = self._prefill_one(req.prompt)
                tok = int(torch.argmax(logits[0, -1]))
                self.prefill_s.append(time.perf_counter() - t0)
                live.append({"req": req, "cache": cache, "lengths": lengths,
                             "tokens": [tok]})

        admit()
        while live:
            t0 = time.perf_counter()
            if len(live) > 1:
                caches = {pos: {k: torch.cat([s["cache"][pos][k] for s in live], dim=1)
                                for k in leaves}
                          for pos, leaves in live[0]["cache"].items()}
                lengths = torch.cat([s["lengths"] for s in live])
            else:
                caches, lengths = live[0]["cache"], live[0]["lengths"]
            last = torch.tensor([[s["tokens"][-1]] for s in live], dtype=torch.int64,
                                device=self.device)
            logits, caches, lengths = self.model.decode(caches, last, lengths)
            nxt = torch.argmax(logits[:, -1], dim=-1).tolist()
            self.decode_step_s.append(time.perf_counter() - t0)
            self.decode_batch.append(len(live))

            done_idx = []
            for i, slot in enumerate(live):
                slot["tokens"].append(int(nxt[i]))
                # this slot's view of the batched cache and lengths
                slot["cache"] = {pos: {k: v[:, i:i + 1] for k, v in leaves.items()}
                                 for pos, leaves in caches.items()}
                slot["lengths"] = lengths[i:i + 1]
                req = slot["req"]
                hit_eos = req.eos_id is not None and int(nxt[i]) == req.eos_id
                if len(slot["tokens"]) >= req.max_new_tokens or hit_eos:
                    req.output = slot["tokens"]
                    req.timing.mark_done()
                    req.latency_s = req.timing.service_s
                    done_idx.append(i)
            for i in reversed(done_idx):
                live.pop(i)
            admit()
        return requests
