"""Chunk-level checkpoint/resume for the streaming pipeline.

The reference's chunked loop (SLAM.h:194-251) is restart-friendly in
spirit but persists no cursor -- a crash at chunk 40 of 50 reruns
everything.  Here every completed chunk atomically persists:

  <out>.cursor.json   {chunks_done, reads_done}
  <out>.partial.pkl   appended pickled per-chunk IdentifiedTaxonomy lists

`--resume` reloads both, seeks the FASTQ streams past reads_done reads,
and reopens the SAM file in append mode.  On successful completion the
sidecar files are removed.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import List, Optional, Tuple


class RunCheckpoint:
    def __init__(self, out_path: str):
        base = out_path or "kslam_run"
        self.cursor_path = base + ".cursor.json"
        self.partial_path = base + ".partial.pkl"

    def load(self) -> Optional[Tuple[int, int, int, List]]:
        """Returns (chunks_done, reads_done, sam_bytes, identified),
        or None when no checkpoint exists.  sam_bytes is the SAM file size
        at the last completed chunk -- a crash mid-chunk leaves partial
        lines past it, which the resume path truncates away."""
        if not os.path.exists(self.cursor_path):
            return None
        with open(self.cursor_path) as f:
            cursor = json.load(f)
        identified: List = []
        if os.path.exists(self.partial_path):
            with open(self.partial_path, "rb") as f:
                while True:
                    try:
                        obj = pickle.load(f)
                    except EOFError:
                        break
                    # per-chunk payload is a list of IdentifiedTaxonomy
                    # (object path) or one columnar ChunkTaxa block
                    if isinstance(obj, list):
                        identified.extend(obj)
                    else:
                        identified.append(obj)
        return (cursor["chunks_done"], cursor["reads_done"],
                cursor.get("sam_bytes", 0), identified)

    def save_chunk(self, chunks_done: int, reads_done: int,
                   new_identified: List, sam_bytes: int = 0) -> None:
        with open(self.partial_path, "ab") as f:
            pickle.dump(new_identified, f)
        tmp = self.cursor_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"chunks_done": chunks_done,
                       "reads_done": reads_done,
                       "sam_bytes": sam_bytes}, f)
        os.replace(tmp, self.cursor_path)

    def clear(self) -> None:
        for p in (self.cursor_path, self.partial_path):
            if os.path.exists(p):
                os.remove(p)
