"""tests/test_validation.py, case for case, against ``buzzdetect_torch``
(import prefix changed, same assertions). No edit beyond the import prefix.

The JAX package's docstring:

Unit tests for argument validators.
"""

from buzzdetect_torch.validation import (
    validate_precision, validate_framehop, validate_chunklength,
    validate_classes_out, validate_int, validate_verbosity, validate_map)


def test_precision_bounds():
    assert validate_precision(None).valid
    assert not validate_precision(0).valid
    assert not validate_precision(1.0).valid
    assert not validate_precision('x').valid
    ok = validate_precision(0.5)
    assert ok.valid and 'false positives' in ok.message
    assert validate_precision(0.95).valid
    assert validate_precision(0.95).message is None


def test_framehop():
    assert not validate_framehop(0).valid
    assert not validate_framehop('x').valid
    assert validate_framehop(0.5).valid
    over = validate_framehop(2.0)
    assert over.valid and over.message  # warns about gaps


def test_chunklength():
    assert validate_chunklength(200).valid
    assert not validate_chunklength(-1).valid
    assert not validate_chunklength('x').valid


def test_classes_out():
    assert validate_classes_out('all').valid
    assert validate_classes_out(['a', 'b']).valid
    # strings are the GUI form representation (split by the launcher)
    assert validate_classes_out('a').valid
    assert validate_classes_out('a, b').valid
    assert not validate_classes_out('').valid
    assert not validate_classes_out([1]).valid


def test_validate_int():
    assert validate_int(None, none_ok=True).valid
    assert not validate_int(None, none_ok=False).valid
    assert not validate_int(-1, none_ok=False, value_min=0).valid
    assert not validate_int(5, none_ok=False, value_max=1).valid
    assert validate_int('3', none_ok=False).valid
    # non-integral floats must be REJECTED, not silently truncated to a
    # value analyze() later crashes on (regression: int(2.9) passed as 2)
    assert not validate_int(2.9, none_ok=False).valid
    assert validate_int(3.0, none_ok=False).valid


def test_verbosity():
    assert validate_verbosity('PROGRESS').valid
    assert not validate_verbosity('LOUD').valid


def test_map_covers_analyze_kwargs():
    expected = {'modelname', 'classes_out', 'precision', 'framehop_prop',
                'chunklength', 'analyzers_cpu', 'analyzers_gpu', 'n_streamers',
                'stream_buffer_depth', 'dir_audio', 'dir_out',
                'verbosity_print', 'verbosity_log', 'log_progress'}
    assert expected <= set(validate_map)


def test_validate_devices():
    from buzzdetect_torch.validation import validate_devices
    assert validate_devices(None).valid
    assert validate_devices('').valid
    assert validate_devices('all').valid
    assert validate_devices(4).valid
    assert validate_devices('4').valid
    assert not validate_devices(0).valid
    assert not validate_devices('many').valid
