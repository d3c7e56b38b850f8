"""The learned-score evidence: ``python -m diffsvc_tpu_torch.tools.train_demo``
and ``python -m diffsvc_tpu_torch.tools.sampler_quality``."""
