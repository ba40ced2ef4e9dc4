"""MSP-Podcast labels: the two emotion orderings and semicolon label lists.

The port's copy of ``nrse_tpu/labels/parsing.py:33-140,198-207``:

  * ``VALID_EMOTIONS_MAP`` — the NRSE ordering A,H,S,F,U,D,C,N of the SER
    trainers (reference ``src/data/emotion_dataset.py:13-22``), and
    ``EMOTIONS_MAP``, the same with X → 8 and O → 9;
  * ``BASELINE_EMOTIONS_MAP`` — the Odyssey-2024 challenge ordering
    A,S,H,U,F,D,C,N (``baseline/eval_cat_ser_weighted_with_list.py:
    86-96``);
  * the list parser (reference ``baseline/eval_cat_ser_weighted_with_list.
    py:57-120``; list fixtures under ``labels/*.txt``): one row per line,
    ``path; EmoClass; A:x; V:y; D:z;``, the emotion indexed in the
    challenge ordering unless another map is given;
  * :func:`clean_filename`, the offline scorer's normalisation of
    augmented file names (``src/metrics/categorical_metrics.py:51-58``).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

# NRSE ordering (reference src/data/emotion_dataset.py:13-22)
VALID_EMOTIONS_MAP: Dict[str, int] = {
    "A": 0,  # Anger
    "H": 1,  # Happiness
    "S": 2,  # Sadness
    "F": 3,  # Fear
    "U": 4,  # Surprise
    "D": 5,  # Disgust
    "C": 6,  # Contempt
    "N": 7,  # Neutral
}
INVALID_EMOTIONS_MAP: Dict[str, int] = {
    "X": 8,  # No agreement
    "O": 9,  # Other
}
EMOTIONS_MAP: Dict[str, int] = {**VALID_EMOTIONS_MAP, **INVALID_EMOTIONS_MAP}

# Odyssey-2024 challenge ordering (reference baseline/...:86-96)
BASELINE_EMOTIONS_MAP: Dict[str, int] = {
    "A": 0,  # Anger
    "S": 1,  # Sadness
    "H": 2,  # Happiness
    "U": 3,  # Surprise
    "F": 4,  # Fear
    "D": 5,  # Disgust
    "C": 6,  # Contempt
    "N": 7,  # Neutral
}


@dataclass
class LabelEntry:
    """One row of a semicolon label list."""

    path: str
    emo_class: str
    emotion: int  # index in the chosen ordering, -1 if unknown/invalid
    arousal: Optional[float] = None
    valence: Optional[float] = None
    dominance: Optional[float] = None
    extra: Dict[str, float] = field(default_factory=dict)


def parse_label_list(
    list_path: str,
    audio_dir: Optional[str] = None,
    emotion_map: Optional[Dict[str, int]] = None,
    drop_invalid: bool = False,
) -> List[LabelEntry]:
    """Parse a semicolon label list into LabelEntry rows.

    Format per line: ``path; EmoClass; A:x; V:y; D:z;``.  Unknown emotion
    codes map to index -1 (reference parity:
    ``baseline/eval_cat_ser_weighted_with_list.py:97``).  With
    ``drop_invalid`` the X/O rows are removed, reproducing the
    ``labels/processed`` filtering (``labels/processed/process_txt_label.py``).
    """
    emotion_map = emotion_map or BASELINE_EMOTIONS_MAP
    entries: List[LabelEntry] = []
    with open(list_path, "r") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            parts = line.split(";")
            if len(parts) < 2:
                continue
            path = parts[0].strip()
            if audio_dir and not os.path.isabs(path):
                path = os.path.join(audio_dir, path)
            emo = parts[1].strip()
            if drop_invalid and emo in INVALID_EMOTIONS_MAP:
                continue
            entry = LabelEntry(path=path, emo_class=emo,
                               emotion=emotion_map.get(emo, -1))
            for seg in parts[2:]:
                seg = seg.strip()
                if not seg or ":" not in seg:
                    continue
                key, value = seg.split(":", 1)
                key, value = key.strip(), value.strip()
                try:
                    fval = float(value)
                except ValueError:
                    entry.extra[key] = value
                    continue
                if key == "A":
                    entry.arousal = fval
                elif key == "V":
                    entry.valence = fval
                elif key == "D":
                    entry.dominance = fval
                else:
                    entry.extra[key] = fval
            entries.append(entry)
    return entries


def clean_filename(filename: str) -> str:
    """The base ``.wav`` name of a path: the directory and an ``_snrN_...``
    suffix stripped."""
    base = os.path.basename(filename)
    if "_snr" in base:
        base = base.split("_snr")[0] + ".wav"
    return base
