from buzzdetect_torch.write.coverage import (  # noqa: F401
    melt_coverage, get_gaps, smooth_gaps, gaps_to_chunklist, coverage_from_csv)
from buzzdetect_torch.write.formatting import (  # noqa: F401
    format_activations, format_detections, ResultTable)
from buzzdetect_torch.write.thresholds import (  # noqa: F401
    calculate_threshold, load_metrics, threshold_at_precision,
    threshold_at_recall)
