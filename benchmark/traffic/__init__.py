"""Request kinds, one module a public entry of the port. Each module gives:

* `HARNESS_SYNCS`: the host waits a request of this kind makes in the
  harness's own code (its end: a synchronize or a read-back);
* `inputs(workload, card, gen, device)`: one clip of the pool, in the
  layout the entry takes;
* `call(model, clip, msg, workload)`: submit the request, return the outputs;
* `finish(outputs)`: wait until the outputs are ready, as the user would;
* `keep(outputs)`: the outputs the check compares;
* `reference(sd, card, clip, msg, workload, ops)`: the same outputs from
  the plain float32 reference (or the control, with lower-precision `ops`);
* `ref_key(clip_index, msg_index)`: requests with one key share a reference;
* `as_kept(ref, workload)`: reference outputs in `keep`'s form (the control's);
* `compare(kept, ref, workload)`: {number: value};
* `flops(card, workload)`: the model FLOPs of one request.
"""
