"""Parallel waveform loading for the LoRA fine-tune.

Light copy of ``interspeech_ser_tpu/baseline/data.py::load_audio`` over the
port's stdlib WAV decoder.
"""

from __future__ import annotations

import concurrent.futures as cf
import os
from typing import List, Sequence

import numpy as np

from ..utils.audio import load_wav


def load_audio(audio_path: str, utts: Sequence[str], num_workers: int = 24) -> List[np.ndarray]:
    """Decode ``audio_path/<utt>`` for each utterance, in order, at 16 kHz mono float32."""
    with cf.ThreadPoolExecutor(max_workers=num_workers) as pool:
        return list(pool.map(lambda u: load_wav(os.path.join(audio_path, u))[0], utts))
