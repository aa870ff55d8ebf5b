from repro_torch.kernels.ref import TreeArrays
