"""The port's examples: the MovieLens matching LP (with its fairness
objective and the MovieLens-shaped proxy held to the reference's logs) and
the MIPLIB 2017 solve, each run as ``python -m dualip_tpu_torch.examples...``."""
