from flexq_tpu_torch.serve.engine import Engine
from flexq_tpu_torch.serve.sampling import SamplingParams, process_logits, sample
