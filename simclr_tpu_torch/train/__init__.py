"""Training engines."""

from simclr_tpu_torch._lazy import lazy_exports

__all__ = lazy_exports(globals(), {
    "common": (
        "History", "TrainState", "adam_torch", "sgd_nesterov",
        "with_grad_accumulation",
    ),
    "lin_eval": (
        "LinearClassifier", "evaluate_linear", "extract_features",
        "linear_evaluation", "train_linear_classifier",
    ),
    "mine": ("MineResult", "train_mine", "train_mine_from_export"),
    "pretrain": (
        "PretrainEngine", "PretrainResult", "build_engine",
        "evaluate_auxiliary", "init_simclr", "pretrain",
    ),
    "ssl": (
        "FineTuneResult", "evaluate_classifier", "init_finetune", "train_ssl",
    ),
    "streaming": ("pretrain_streaming",),
    "supervised": ("SupervisedResult", "train_supervised"),
})
