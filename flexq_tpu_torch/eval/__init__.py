from flexq_tpu_torch.eval.data import (
    dataset_available,
    DEFAULT_WIKITEXT2,
    calib_samples,
    load_wikitext2_text,
    tokenize_eval_ids,
)
from flexq_tpu_torch.eval.ppl import perplexity, window_nll
from flexq_tpu_torch.eval.zeroshot import (
    GEN_TASK_ADAPTERS,
    GREEDY_PAIR_ADAPTERS,
    TASK_ADAPTERS,
    evaluate_generation,
    evaluate_greedy_completion,
    evaluate_lambada,
    evaluate_multiple_choice,
    lambada_cloze_pairs,
)
