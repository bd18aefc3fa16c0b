from flexq_tpu_torch.packing.pack4 import BIAS4, pack4, unpack4
from flexq_tpu_torch.packing.pack6 import BIAS, PACK_KT, pack6, unpack6
