"""The JAX package's LM examples (``examples/``) on the port. Each runs
as ``python -m repro_torch.examples.<name>`` on the CUDA device, or on
the host with ``--device cpu``; importing one runs nothing.

- ``elastic_failover``: the Supervisor walk-through (a failure, a
  remesh, a restore, a straggler evicted);
- ``train_lm``: a ~100M dense model trained, checkpointed and resumed;
- ``serve_batch``: reduced qwen2.5-3b, mamba2-1.3b and jamba served;
- ``quickstart``: the LM steps of the JAX quickstart (MoE overflow
  stealing, a short training run).
"""
