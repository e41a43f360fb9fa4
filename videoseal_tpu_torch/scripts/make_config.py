"""A model card from a training checkpoint, counterpart of
``videoseal_tpu/scripts/make_config.py``.

The train CLI saves its args beside the checkpoint (``args.json``); this
writes the card dict the JAX package writes, as JSON text. JSON is YAML, so
the file (``card.yaml`` by default) loads in both packages: the JAX
package's `load` reads it with yaml.safe_load, the port's
(``utils/cfg.load_card``) with json. Floats are written with a point and a
signed exponent ("1.0e-06"), the form YAML 1.1 reads as a float.

  python -m videoseal_tpu_torch.scripts.make_config ckpt.npz [--args_json args.json] \\
      [--output card.yaml]
"""

from __future__ import annotations

import argparse
import json
import os

CARD_ARGS = ("nbits", "img_size", "scaling_w", "scaling_i", "attenuation")


def make_card(checkpoint: str, targs: dict) -> dict:
    """The card of `checkpoint` from its training args."""
    return {
        "checkpoint_path": os.path.abspath(checkpoint),
        "args": {k: targs[k] for k in CARD_ARGS if k in targs},
        "embedder": targs.get("embedder_card", {}),
        "extractor": targs.get("extractor_card", {}),
    }


def _float(x: float) -> str:
    text = repr(x)
    if text in ("inf", "-inf", "nan"):
        raise ValueError(f"{text} has no JSON form")
    mant, _, exp = text.partition("e")
    if "." not in mant:
        mant += ".0"
    if exp and exp[0] not in "+-":
        exp = "+" + exp
    return mant + ("e" + exp if exp else "")


def dumps(obj, indent: int = 0) -> str:
    """`obj` (dicts, lists, strings, numbers, booleans, None) as JSON text
    that YAML 1.1 reads back to the same values, in insertion order."""
    pad, inner = "  " * indent, "  " * (indent + 1)
    if isinstance(obj, dict):
        if not obj:
            return "{}"
        items = [f"{inner}{json.dumps(str(k))}: {dumps(v, indent + 1)}" for k, v in obj.items()]
        return "{\n" + ",\n".join(items) + f"\n{pad}}}"
    if isinstance(obj, (list, tuple)):
        if not obj:
            return "[]"
        return "[\n" + ",\n".join(inner + dumps(v, indent + 1) for v in obj) + f"\n{pad}]"
    if isinstance(obj, float):
        return _float(obj)
    return json.dumps(obj)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("checkpoint")
    ap.add_argument("--args_json", default=None,
                    help="training args json (defaults to <ckptdir>/args.json)")
    ap.add_argument("--output", default="card.yaml")
    args = ap.parse_args(argv)

    args_path = args.args_json or os.path.join(os.path.dirname(args.checkpoint), "args.json")
    with open(args_path) as f:
        targs = json.load(f)
    card = make_card(args.checkpoint, targs)
    with open(args.output, "w") as f:
        f.write(dumps(card) + "\n")
    print(f"wrote {args.output}")
    return card


if __name__ == "__main__":
    main()
