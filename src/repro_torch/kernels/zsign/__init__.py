from repro_torch.kernels.zsign.ops import (sign_reduce, zsign_compress,  # noqa: F401
                                           zsign_decompress_sum)
