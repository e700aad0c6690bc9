"""The reference's entry points on the port (counterparts of
`examples/test.py`, `examples/nvsr_main.py` and `examples/train_nvsr.py`),
each runnable as `python -m ssr_eval_tpu_torch.examples.<name>`: on the
CUDA card, or on the CPU with `device="cpu"`."""
