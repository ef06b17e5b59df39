"""Text-audio manifests. Only `T2ADataset.from_json`, which the test-set CLI
reads, is ported so far; augmentation and the batching loader come with the
rest of training."""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import List, Optional


@dataclass
class T2ADataset:
    """Text-audio pairs from a json manifest: {"data": [{...}, ...]}, a JSON
    list of rows, or jsonl, each row carrying the caption and wav-path
    columns (the reference's data/*.json)."""

    captions: List[str]
    paths: List[str]
    segment_length: int = 1024 * 160
    target_sr: int = 16000

    @classmethod
    def from_json(cls, path: str, text_column: str = "captions",
                  audio_column: str = "location", num_examples: int = -1,
                  prefix: Optional[str] = None, **kwargs) -> "T2ADataset":
        """`prefix` is prepended to every caption (the reference's --prefix)."""
        rows: List[dict] = []
        with open(path) as f:
            first = f.read(1)
            f.seek(0)
            if first == "{":
                try:
                    obj = json.load(f)
                    if isinstance(obj, dict):
                        # a {"data": [...]} manifest, or a single jsonl row
                        rows = obj["data"] if "data" in obj else [obj]
                    else:
                        rows = obj
                except json.JSONDecodeError:
                    f.seek(0)
                    rows = [json.loads(line) for line in f if line.strip()]
            elif first == "[":
                rows = json.load(f)
            else:
                rows = [json.loads(line) for line in f if line.strip()]
        if num_examples > 0:
            rows = rows[:num_examples]
        return cls(captions=[(prefix or "") + r[text_column] for r in rows],
                   paths=[r[audio_column] for r in rows], **kwargs)

    def __len__(self) -> int:
        return len(self.captions)
