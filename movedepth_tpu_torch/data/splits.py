"""Where the port finds a KITTI split's files.

One rule for the trainer, the evaluator and the GT export: a split
directory given by the caller (``--splits_dir``) holds every file of the
split. Without one, a file of split ``<name>`` is read from the port's own
``movedepth_tpu_torch/splits/<name>/`` (where ``cli.import_splits`` and
``cli.export_gt`` write) when it is there, plain or gzipped, and otherwise
from the split lists bundled with the checkout under
``movedepth_tpu/splits/<name>/``, which the port reads as data files and
never writes.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

PORT_SPLITS = Path(__file__).resolve().parents[1] / "splits"
BUNDLED_SPLITS = Path(__file__).resolve().parents[2] / "movedepth_tpu" \
    / "splits"


def split_file(split: str, name: str,
               split_dir: Optional[str] = None) -> str:
    """Path of file ``name`` (e.g. ``test_files.txt``, ``gt_depths.npz``)
    of ``split``: in ``split_dir`` when one is given, else in the port's
    split directory when it holds the file or its ``.gz``, else in the
    bundled one (the path named even when absent, so a reader's error
    names it)."""
    if split_dir:
        return os.path.join(split_dir, name)
    own = PORT_SPLITS / split / name
    if own.exists() or own.with_name(name + ".gz").exists():
        return str(own)
    return str(BUNDLED_SPLITS / split / name)
