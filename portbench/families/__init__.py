"""Model families, one module each, found by the configuration file's
``family`` (``lookup.family``).  A family holds everything that knows the
model:

- ``build(cfg, seed, device)``: the program's model with the benchmark's
  weights loaded (made by ``weights.make_weights`` with the family's rule),
  and those weights, float32 on the CPU, for the reference;
- ``input_shape(cfg, batch)`` and ``conditions(cfg, n, batch, generator,
  device)``: a batch's model input shape and its conditioning ({name:
  (n, batch, ...)} tensors, drawn after the inputs), for the jobs;
- ``forward_terms`` / ``forward_flops(cfg, batch)``: the model FLOPs of a
  forward (``mfu.*``);
- ``scan_shapes(cfg, batch)``: (batch, L, d_inner, d_state) of each scan a
  forward runs (the scan and conv rooflines);
- ``reference``: the plain reference module the jobs check against.
"""
