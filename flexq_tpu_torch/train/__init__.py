from flexq_tpu_torch.train.corpus import build_corpus, train_tokenizer
from flexq_tpu_torch.train.trainer import (
    TrainConfig,
    init_params,
    train_step,
    make_lr_schedule,
    save_checkpoint,
    load_checkpoint,
)
