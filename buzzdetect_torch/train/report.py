"""Model-card artifacts: the plots and history a trained model ships with.

The reference distributes each model with an evaluation report the runtime
never reads but users do — training-loss curves and threshold/activation
plots alongside the load-bearing ``tests/metrics.csv`` (reference
``models/model_general_v3/``: ``loss_curves.svg``, ``history.pickle``,
``tests/{metrics.svg, metrics_buzz.svg, activation_overall.svg,
activation_pitch.svg, positives.svg}``). The producing harness is absent
from the reference tree; this module regenerates the same artifact set from
a training run's history and a held-out evaluation, so a bundle trained by
``buzzdetect_torch.tools.train_model`` carries the same model card a
reference model does.

Matplotlib is an optional dependency of THIS module only — the inference
pipeline never imports it. History is stored as JSON rather than a pickle:
the artifact is documentation, and documentation should not require
arbitrary-code deserialization to read.

Copy of ``buzzdetect_tpu/train/report.py``, import prefix changed.

Chart conventions (shared across the set): one y-scale per axes (measures of
different scale get their own small-multiple panel, never a twin axis);
categorical series take hues in a fixed order; text and labels stay in
neutral ink; grids are recessive.
"""

import json
import os

import numpy as np

# Fixed-order categorical palette (colorblind-safe adjacent pairs on a
# light surface); series take slots in order, never cycled.
PALETTE = ('#2a78d6', '#eb6834', '#1baf7a', '#eda100', '#e87ba4', '#008300')
_INK = '#333333'
_GRID = '#dddddd'


def _plt():
    try:
        import matplotlib
    except ImportError as e:  # pragma: no cover - env without matplotlib
        raise ImportError(
            'model-card plots need matplotlib, which is not installed; '
            'pass report=False (or --no-report) to skip them') from e
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    return plt


def _style(ax):
    ax.grid(True, color=_GRID, linewidth=0.6)
    ax.set_axisbelow(True)
    for side in ('top', 'right'):
        ax.spines[side].set_visible(False)
    for side in ('left', 'bottom'):
        ax.spines[side].set_color(_INK)
    ax.tick_params(colors=_INK, labelsize=9)
    ax.xaxis.label.set_color(_INK)
    ax.yaxis.label.set_color(_INK)
    ax.title.set_color(_INK)


def _save(fig, path):
    os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
    fig.savefig(path, bbox_inches='tight')  # format from the extension
    import matplotlib.pyplot as plt
    plt.close(fig)
    return path


def save_history(path, history):
    """Write training history as JSON (``loss_curves``' data; the
    reference's ``history.pickle`` analog). ``history`` maps curve name
    ('loss', 'val_loss', ...) to a per-epoch sequence."""
    os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
    clean = {k: [float(x) for x in v] for k, v in history.items()}
    with open(path, 'w') as f:
        json.dump(clean, f, indent=1)
    return path


def load_history(path):
    with open(path) as f:
        return {k: np.asarray(v, np.float64) for k, v in json.load(f).items()}


def plot_loss_curves(path, history):
    """Training-loss curves per epoch (reference ``loss_curves.svg``)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(6, 3.6))
    for i, (name, values) in enumerate(history.items()):
        values = np.asarray(values, np.float64)
        ax.plot(np.arange(len(values)), values, color=PALETTE[i % len(PALETTE)],
                linewidth=2, label=name)
    ax.set_xlabel('epoch')
    ax.set_ylabel('loss')
    ax.set_title('training loss')
    if len(history) > 1:
        ax.legend(frameon=False, labelcolor=_INK)
    _style(ax)
    return _save(fig, path)


def plot_metrics(path, metrics):
    """Threshold sweep as three stacked panels sharing the threshold axis
    (reference ``tests/metrics.svg``). Precision, sensitivity, and false
    positive rate live on very different scales, so each gets its own
    y-axis panel instead of overloaded twin axes."""
    plt = _plt()
    panels = [('precision', PALETTE[0]), ('sensitivity', PALETTE[1]),
              ('false positive rate', PALETTE[2])]
    keys = ['precision', 'sensitivity', 'fpr']
    fig, axes = plt.subplots(3, 1, figsize=(6, 6.6), sharex=True)
    t = np.asarray(metrics['threshold'], np.float64)
    for ax, (title, color), key in zip(axes, panels, keys):
        ax.plot(t, np.asarray(metrics[key], np.float64), color=color,
                linewidth=2)
        ax.set_ylabel(title)
        _style(ax)
    axes[-1].set_xlabel('threshold')
    axes[0].set_title('detection metrics by threshold')
    fig.align_ylabels(axes)
    return _save(fig, path)


def plot_activation_overall(path, scores, positives, target_class='ins_buzz'):
    """Activation distributions for positive vs negative frames (reference
    ``tests/activation_overall.svg``). Step histograms, density-normalized
    so an imbalanced eval set still shows both shapes."""
    plt = _plt()
    scores = np.asarray(scores, np.float64)
    positives = np.asarray(positives).astype(bool)
    fig, ax = plt.subplots(figsize=(6, 3.6))
    lo, hi = float(scores.min()), float(scores.max())
    if lo == hi:
        lo, hi = lo - 0.5, hi + 0.5
    bins = np.linspace(lo, hi, 41)
    for sel, name, color in ((positives, target_class, PALETTE[0]),
                             (~positives, f'non-{target_class}', PALETTE[1])):
        if sel.any():
            ax.hist(scores[sel], bins=bins, density=True, histtype='step',
                    linewidth=2, color=color, label=name)
    ax.set_xlabel('activation')
    ax.set_ylabel('density')
    ax.set_title(f'activation for {target_class} and non-{target_class} '
                 f'frames')
    ax.legend(frameon=False, labelcolor=_INK)
    _style(ax)
    return _save(fig, path)


def plot_activation_groups(path, groups, title='activation by group'):
    """Activation distributions per named subgroup as boxplots (reference
    ``tests/activation_pitch.svg``, which splits buzzes by pitch).
    ``groups``: ordered mapping of group name -> activation array."""
    plt = _plt()
    names = list(groups)
    data = [np.asarray(groups[n], np.float64) for n in names]
    fig, ax = plt.subplots(figsize=(1.2 + 1.1 * len(names), 3.6))
    boxes = ax.boxplot(data, tick_labels=names, patch_artist=True,
                       medianprops={'color': _INK})
    for patch in boxes['boxes']:
        patch.set_facecolor(PALETTE[0])
        patch.set_alpha(0.35)
        patch.set_edgecolor(PALETTE[0])
    ax.set_ylabel('activation')
    ax.set_title(title)
    _style(ax)
    return _save(fig, path)


def plot_group_metrics(path, group_metrics, title='sensitivity by group'):
    """Sensitivity vs achieved precision per subgroup (reference
    ``tests/metrics_buzz.svg``: how each buzz pitch fares as the operating
    precision tightens). ``group_metrics``: ordered mapping of group name ->
    metrics dict (threshold/precision/sensitivity arrays)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(6, 3.6))
    for i, (name, m) in enumerate(group_metrics.items()):
        order = np.argsort(np.asarray(m['precision'], np.float64))
        ax.plot(np.asarray(m['precision'], np.float64)[order],
                np.asarray(m['sensitivity'], np.float64)[order],
                color=PALETTE[i % len(PALETTE)], linewidth=2, label=name)
    ax.set_xlabel('precision')
    ax.set_ylabel('sensitivity')
    ax.set_title(title)
    ax.legend(frameon=False, labelcolor=_INK, title='group')
    _style(ax)
    return _save(fig, path)


def detection_outcomes(scores, labels, classes, target_class='ins_buzz',
                       threshold=0.0):
    """Confusion outcome counts per annotated label at one operating point
    (the data behind reference ``tests/positives.svg``).

    Each eval frame is thresholded on the target class's activation; the
    outcome (true/false positive/negative, judged against the frame's
    target-class label) is then tallied under every label the frame
    carries, so e.g. 'mech_plane' rows show how planes confuse the buzz
    detector. Returns ``{label: {outcome: count}}`` ordered by total count.
    """
    scores = np.asarray(scores, np.float64)
    labels = np.asarray(labels).astype(bool)
    classes = list(classes)
    ci = classes.index(target_class)
    detected = scores > threshold
    truth = labels[:, ci]
    outcome = np.where(
        detected, np.where(truth, 'true positive', 'false positive'),
        np.where(truth, 'false negative', 'true negative'))
    counts = {}
    unlabeled = ~labels.any(axis=1)
    for li, label in enumerate(classes + ['(unlabeled)']):
        sel = unlabeled if label == '(unlabeled)' else labels[:, li]
        if not sel.any():
            continue
        counts[label] = {o: int((outcome[sel] == o).sum())
                         for o in ('true positive', 'false positive',
                                   'true negative', 'false negative')}
    return dict(sorted(counts.items(),
                       key=lambda kv: -sum(kv[1].values())))


_OUTCOME_COLORS = {
    'true positive': PALETTE[0], 'false positive': PALETTE[1],
    'true negative': PALETTE[2], 'false negative': PALETTE[3],
}


def plot_positives(path, counts, subtitle=None):
    """Detection outcomes per annotated label as grouped horizontal bars
    (reference ``tests/positives.svg``). ``counts`` comes from
    :func:`detection_outcomes`; ``subtitle`` typically records the operating
    point ('precision 0.9 | threshold -1.23 | ...')."""
    plt = _plt()
    labels = list(counts)
    outcomes = list(_OUTCOME_COLORS)
    fig, ax = plt.subplots(figsize=(7, 1.0 + 0.8 * max(1, len(labels))))
    height = 0.19
    y = np.arange(len(labels))[::-1]
    for i, o in enumerate(outcomes):
        vals = [counts[lb].get(o, 0) for lb in labels]
        ax.barh(y + (1.5 - i) * height, vals, height=height * 0.9,
                color=_OUTCOME_COLORS[o], label=o)
    ax.set_yticks(y)
    ax.set_yticklabels(labels)
    ax.set_xlabel('frames')
    title = 'true and false positives by label'
    if subtitle:
        title += f'\n{subtitle}'
    ax.set_title(title)
    # outside the axes: bars commonly span the full width, so any inside
    # placement can sit on a bar
    ax.legend(frameon=False, labelcolor=_INK, title='call',
              loc='center left', bbox_to_anchor=(1.02, 0.5))
    _style(ax)
    return _save(fig, path)


def _operating_point(metrics, precision_target):
    """Lowest threshold whose measured precision meets the target (the
    conventional operating point); falls back to the most precise row when
    the table never reaches the target."""
    p = np.asarray(metrics['precision'], np.float64)
    t = np.asarray(metrics['threshold'], np.float64)
    s = np.asarray(metrics['sensitivity'], np.float64)
    ok = np.where(p >= precision_target)[0]
    i = ok[np.argmin(t[ok])] if ok.size else int(np.argmax(p))
    return float(t[i]), float(p[i]), float(s[i])


def write_model_report(dir_model, history=None, metrics=None, scores=None,
                       labels=None, classes=None, target_class='ins_buzz',
                       groups=None, precision_target=0.9):
    """Write the full model-card artifact set into a model directory.

    * ``history`` -> ``history.json`` + ``loss_curves.svg`` (model root);
    * ``metrics`` (threshold sweep dict) -> ``tests/metrics.svg``;
    * ``scores``/``labels``/``classes`` (held-out frame activations for the
      target class + multi-hot truth) -> ``tests/activation_overall.svg``
      and ``tests/positives.svg`` at the ``precision_target`` operating
      point (resolved from ``metrics`` when given, else threshold 0);
    * ``groups`` (name -> boolean frame mask) -> ``tests/activation_<x>.svg``
      and a per-group sweep ``tests/metrics_<target>.svg``.

    Every input is optional; only the artifacts whose data was supplied are
    written. Returns the list of written paths.
    """
    from buzzdetect_torch.train.evaluate import threshold_sweep

    written = []
    tests = os.path.join(dir_model, 'tests')
    if history is not None:
        if not isinstance(history, dict):
            history = {'loss': history}
        written.append(save_history(
            os.path.join(dir_model, 'history.json'), history))
        written.append(plot_loss_curves(
            os.path.join(dir_model, 'loss_curves.svg'), history))
    if metrics is not None:
        written.append(plot_metrics(
            os.path.join(tests, 'metrics.svg'), metrics))
    if scores is not None and labels is not None and classes is not None:
        scores = np.asarray(scores, np.float64)
        labels = np.asarray(labels).astype(bool)
        ci = list(classes).index(target_class)
        written.append(plot_activation_overall(
            os.path.join(tests, 'activation_overall.svg'), scores,
            labels[:, ci], target_class))
        if metrics is not None:
            thr, prec, sens = _operating_point(metrics, precision_target)
            note = (f'precision {round(prec, 2)} | threshold '
                    f'{round(thr, 2)} | sensitivity {round(sens, 2)}')
        else:
            thr, note = 0.0, 'threshold 0.0 (no metrics table)'
        written.append(plot_positives(
            os.path.join(tests, 'positives.svg'),
            detection_outcomes(scores, labels, classes, target_class, thr),
            note))
        if groups:
            acts = {name: scores[np.asarray(mask).astype(bool)]
                    for name, mask in groups.items()}
            acts = {k: v for k, v in acts.items() if v.size}
            if acts:
                written.append(plot_activation_groups(
                    os.path.join(tests, 'activation_groups.svg'), acts,
                    f'{target_class} activation by group'))
            sweeps = {}
            for name, mask in groups.items():
                mask = np.asarray(mask).astype(bool)
                # sweep this group's positives against ALL negatives: the
                # question is how well the detector separates this subgroup
                # from the background, not from the other subgroups
                sel = mask | ~labels[:, ci]
                try:
                    sweeps[name] = threshold_sweep(
                        scores[sel], (labels[:, ci] & mask)[sel])
                except ValueError:
                    continue  # one-sided subgroup: nothing to sweep
            if sweeps:
                written.append(plot_group_metrics(
                    os.path.join(tests, f'metrics_{target_class}.svg'),
                    sweeps, f'sensitivity by group ({target_class})'))
    return written
