"""Scripts of the port, run as modules on the card
(``python -m etcd_tpu_torch.scripts.<name>``): the raw-CRC variant race,
the kernel tile sweep, the host WAL builder they share with
``chip_smoke.py``, the co-hosted serving phases (``cohosted_bench``),
the dist tier's (``dist_bench``, ``dist_node``), the role-split
topology's (``roles_bench``), BASELINE config 5 on virtual shards of one
card (``config5_bench``), the soak (``soak``), the device-init probe
(``device_probe``) and a probe of the profiler's sessions
(``profiler_sessions``)."""
