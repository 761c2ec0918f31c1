"""Developer tools of the port: the capability probe of the hand-written
kernels (``capability_probe``), the speed-of-light table (``roofline``) and
the pipeline profiler (``profile_pipeline``). Each runs as
``python -m buzzdetect_torch.tools.<name>``."""
