"""The batched event core: buffers, kernels, the window engine, PHOLD."""
