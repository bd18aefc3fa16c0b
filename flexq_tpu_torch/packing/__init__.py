from flexq_tpu_torch.packing.pack6 import BIAS, PACK_KT, pack6, unpack6
