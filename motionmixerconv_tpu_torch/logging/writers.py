"""Metric logging: always a ``metrics.jsonl``; TensorBoard event files too
where the ``tensorboard`` package imports.

Counterpart of ``motionmixerconv_tpu/logging/writers.py`` (the reference's
``SummaryWriter.add_scalar`` surface, train_mixer_h36m.py:57,265-274).
"""

from __future__ import annotations

import json
import os
import time


class MetricLogger:
    """add_scalar-compatible logger writing JSONL and, if available, TB
    events."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.log_dir = log_dir
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        try:
            from tensorboard.summary.writer.event_file_writer import (
                EventFileWriter,
            )
        except ImportError:  # no tensorboard: JSONL only
            self._tb = None
        else:
            self._tb = EventFileWriter(log_dir)

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        value = float(value)
        now = time.time()
        self._jsonl.write(json.dumps(
            {"tag": tag, "value": value, "step": int(step), "t": now}) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            from tensorboard.compat.proto.event_pb2 import Event
            from tensorboard.compat.proto.summary_pb2 import Summary

            summary = Summary(value=[Summary.Value(tag=tag, simple_value=value)])
            self._tb.add_event(Event(summary=summary, step=int(step),
                                     wall_time=now))

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
