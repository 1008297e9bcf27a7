"""Active-sequence load tracking.

Port of dynamo_tpu/router/sequences.py `ActiveSequences`: the router
predicts each worker's load without waiting for engine metrics. Routing a
request charges its worker the request's prefill blocks (less the overlap
it already holds) and a decode-block projection; the first token turns
the prefill charge into decode charge; free releases everything.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

Worker = Tuple[int, int]


@dataclass
class _ActiveRequest:
    worker: Worker
    prefill_blocks: int  # blocks still being prefilled (not yet cached)
    decode_blocks: int  # blocks projected for the active decode
    prefill_done: bool = False


class ActiveSequences:
    def __init__(self):
        self._requests: Dict[str, _ActiveRequest] = {}
        self._prefill: Dict[Worker, int] = {}
        self._decode: Dict[Worker, int] = {}

    # -- lifecycle ---------------------------------------------------------
    def add_request(
        self,
        request_id: str,
        worker: Worker,
        total_blocks: int,
        overlap_blocks: int,
        expected_output_blocks: int = 1,
    ) -> None:
        new_prefill = max(0, total_blocks - overlap_blocks)
        req = _ActiveRequest(
            worker=worker,
            prefill_blocks=new_prefill,
            decode_blocks=total_blocks + expected_output_blocks,
        )
        self._requests[request_id] = req
        self._prefill[worker] = self._prefill.get(worker, 0) + new_prefill
        self._decode[worker] = self._decode.get(worker, 0) + req.decode_blocks

    def mark_prefill_completed(self, request_id: str) -> None:
        req = self._requests.get(request_id)
        if req is None or req.prefill_done:
            return
        req.prefill_done = True
        self._prefill[req.worker] = max(0, self._prefill.get(req.worker, 0) - req.prefill_blocks)

    def free(self, request_id: str) -> None:
        req = self._requests.pop(request_id, None)
        if req is None:
            return
        if not req.prefill_done:
            self._prefill[req.worker] = max(
                0, self._prefill.get(req.worker, 0) - req.prefill_blocks
            )
        self._decode[req.worker] = max(0, self._decode.get(req.worker, 0) - req.decode_blocks)

    def remove_worker(self, worker: Worker) -> None:
        for rid in [r for r, req in self._requests.items() if req.worker == worker]:
            self.free(rid)
        self._prefill.pop(worker, None)
        self._decode.pop(worker, None)

    # -- load queries ------------------------------------------------------
    def prefill_blocks(self, worker: Worker) -> int:
        return self._prefill.get(worker, 0)

    def decode_blocks(self, worker: Worker) -> int:
        return self._decode.get(worker, 0)
