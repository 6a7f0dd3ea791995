"""The port's examples (ports of ``examples/``): ``python -m
crs_tpu_torch.examples.quickstart`` (the whole workflow in one run) and
``python -m crs_tpu_torch.examples.pq_serving`` (a residual-PQ store served
through the three ``pq_rescore`` modes), on the card unless ``--device cpu``."""
