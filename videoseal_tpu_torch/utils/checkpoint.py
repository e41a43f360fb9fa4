"""Reading the JAX package's native ``.npz`` checkpoints, numpy only.

Counterpart of ``load_npz`` and ``unflatten_tree`` in
``videoseal_tpu/utils/checkpoint.py``: the file holds flattened
``embedder//params//...`` and ``extractor//...`` arrays (and an
``__args__`` JSON blob that this reader leaves alone). The trees it returns
go through ``utils/convert.py::from_jax_variables`` into the port's state
dicts.
"""

from __future__ import annotations

import numpy as np

SEP = "//"


def unflatten_tree(flat: dict) -> dict:
    tree: dict = {}
    for path, v in flat.items():
        keys = path.split(SEP)
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = v
    return tree


def load_npz(path: str) -> tuple[dict, dict]:
    """(embedder variables, extractor variables) as nested dicts of arrays."""
    with np.load(path) as data:
        tree = unflatten_tree({k: data[k] for k in data.files})
    return tree.get("embedder", {}), tree.get("extractor", {})
