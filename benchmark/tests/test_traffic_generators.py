"""The traffic generators: the same seed gives the same inputs."""

import json
import os

import numpy as np
import pytest

from benchmark import synth
from benchmark.traffic import chunks

BIG_SEED = 2 ** 33 + 17
HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MIXES = sorted(f[:-5] for f in os.listdir(os.path.join(HERE, 'traffic'))
               if f.endswith('.json'))


def test_field_audio_is_seeded_and_int16():
    a = synth.recordings(BIG_SEED, 2, 3.0)
    b = synth.recordings(BIG_SEED, 2, 3.0)
    c = synth.recordings(BIG_SEED + 1, 2, 3.0)
    assert all(x.dtype == np.int16 and len(x) == 48000 for x in a)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], c[0])
    assert not np.array_equal(a[0], a[1])


def test_chunks_are_seeded_and_as_long_as_the_configuration_says():
    config = {'chunklength': 2.5}
    a = chunks.generate({'chunks': 3}, config, BIG_SEED)['chunks']
    b = chunks.generate({'chunks': 3}, config, BIG_SEED)['chunks']
    assert len(a) == 3 and all(np.array_equal(x, y) for x, y in zip(a, b))
    assert all(len(x) == 40000 and x.dtype == np.int16 for x in a)
    # pinned only where asked for and a card is there to pin for
    pinned = chunks.generate({'chunks': 3, 'pinned': True}, config,
                             BIG_SEED)['chunks']
    assert all(np.array_equal(x, y) for x, y in zip(a, pinned))
    short = chunks.generate({'chunks': 1, 'chunk_seconds': 1.0}, config,
                            BIG_SEED)['chunks']
    assert len(short[0]) == 16000


@pytest.mark.parametrize('name', MIXES)
def test_traffic_files_name_their_generator_and_entry(name):
    t = json.load(open(os.path.join(HERE, 'traffic', name + '.json')))
    assert os.path.isfile(os.path.join(HERE, 'traffic',
                                       t['generator'] + '.py'))
    assert os.path.isfile(os.path.join(HERE, 'entries', t['entry'] + '.py'))
    # a mix runs at the configuration's chunk length; only the rehearsal
    # shortens it
    assert 'chunk_seconds' not in t['params']
    assert set(t['rehearsal']) <= set(t['params']) | {'chunk_seconds'}
