from flexq_tpu_torch.serve.engine import Engine
from flexq_tpu_torch.serve.sampling import SamplingParams, process_logits, sample
from flexq_tpu_torch.serve.beam import BeamParams, beam_search
from flexq_tpu_torch.serve.paged import PagePool, PageTable
from flexq_tpu_torch.serve.scheduler import BatchScheduler
from flexq_tpu_torch.serve.speculative import SpecStats, generate_speculative, ngram_draft
