"""Run scripts of the port (`python -m dgvit_tpu_torch.examples.<name>`)."""
