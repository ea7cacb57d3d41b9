"""Training of the dense, ssm and hybrid families on one card (counterpart of ``repro.train``):
``optimizer`` (AdamW, schedules), ``train_step`` (microbatches, the update)
and ``checkpoint`` (atomic npz + manifest, async manager). The int8
gradient sync (``grad_comm``) and elastic recovery are later ROADMAP items."""
