from repro_torch.kernels.efsign.ops import (ef_sign_encode,  # noqa: F401
                                            ef_sign_update)
