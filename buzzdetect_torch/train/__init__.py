from buzzdetect_torch.train.trainer import (  # noqa: F401
    bce_with_logits_loss, make_head_train_step, make_full_train_step,
    train_head)
from buzzdetect_torch.train.evaluate import (  # noqa: F401
    threshold_sweep, evaluate_scores, write_metrics_csv)
from buzzdetect_torch.train.report import (  # noqa: F401
    write_model_report, save_history, load_history, detection_outcomes)
