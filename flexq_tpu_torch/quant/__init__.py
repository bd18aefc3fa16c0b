from flexq_tpu_torch.quant.quantizer import (
    CLIPMAX,
    CLIPMIN,
    QuantSpec,
    dequantize,
    fake_quant,
    quantize,
)
