"""In-situ stage timing for the traced run: forward pre- and post-hooks
that record CUDA events on the program's own modules, inside the real timed
calls. A stage starts at the pre-hook of one
module and ends at the post-hook of another (the same one, or the last of a
chain such as the VAE's post_quant_conv ... decoder). Each start also notes
the batch the module was called with. Times are summed per request."""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional

import torch


class StageTimer:
    def __init__(self, device):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.request: Optional[int] = None
        self.spans: List[list] = []  # [stage, request, batch, start, end]
        self.handles = []

    def _event(self):
        if not self.cuda:
            return None
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def _start(self, stage):
        def hook(module, args):
            batch = args[0].shape[0] if args and hasattr(args[0], "shape") else None
            self.spans.append([stage, self.request, batch, self._event(), None])
        return hook

    def _end(self, stage):
        def hook(module, args, output=None):
            for span in reversed(self.spans):
                if span[0] == stage and span[4] is None:
                    span[4] = self._event() if self.cuda else True
                    return
        return hook

    def stage(self, name: str, start: torch.nn.Module, end: torch.nn.Module = None):
        self.handles.append(start.register_forward_pre_hook(self._start(name)))
        self.handles.append((end or start).register_forward_hook(self._end(name)))

    def remove(self):
        for h in self.handles:
            h.remove()
        self.handles = []

    def calls(self, stage: str) -> Dict[int, List[int]]:
        """{request: [batch of each call]} of a stage."""
        out = defaultdict(list)
        for s, req, batch, _, _ in self.spans:
            if s == stage:
                out[req].append(batch)
        return dict(out)

    def ms_per_request(self) -> Dict[str, Dict[int, float]]:
        """{stage: {request: ms summed over the stage's calls}}; card only."""
        if self.cuda:
            torch.cuda.synchronize(self.device)
        out: Dict[str, Dict[int, float]] = defaultdict(lambda: defaultdict(float))
        for stage, req, _, start, end in self.spans:
            if self.cuda and end is not None:
                out[stage][req] += start.elapsed_time(end)
        return {k: dict(v) for k, v in out.items()}
