"""The benchmark of the PyTorch / CUDA port ``iterativesolvers_tpu_torch``
(``README.md`` says how to run it and how to add to it)."""
