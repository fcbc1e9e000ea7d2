"""Scripts of the port, run as modules on the card
(``python -m etcd_tpu_torch.scripts.<name>``): the raw-CRC variant race,
the kernel tile sweep, and the host WAL builder they share with
``chip_smoke.py``."""
