from mlic_tpu_torch.entropy.rans.coder import (  # noqa: F401
    BufferedRansEncoder,
    RansDecoder,
    decode_with_indexes,
    encode_with_indexes,
    rans_backend,
)

__all__ = ["BufferedRansEncoder", "RansDecoder", "encode_with_indexes",
           "decode_with_indexes", "rans_backend"]
