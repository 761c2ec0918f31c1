"""Model and embedder plugin system.

Contract parity with the reference's plugin loaders
(`src/inference/models.py:12-79`, `src/inference/embedding.py:8-79`): a model
is a directory ``models/<name>/`` and an embedder a directory
``embedders/<name>/``; a ``model.py`` / ``embedder.py`` in the directory is
imported and its Base subclass instantiated, so users can drop in custom
models without touching the framework. Additionally (superset), a model
directory containing a ``model.npz`` bundle needs *no* Python plugin — the
built-in :class:`BundleModel` runs it on one torch device (``'cuda'`` unless
the caller asks for ``'cpu'``), or split over a device mesh (``mesh=``,
``sharding=``). A directory whose ``config_model.json`` names
``"architecture": "ast"`` is the Audio Spectrogram Transformer
(:class:`ASTModel`, ``models/ast.py``), with its weights from
``model.npz`` where one is present, else from the seed the file gives
(``"weights": "seeded"``); ``"architecture": "beats"`` is BEATs
(:class:`BEATsModel`, ``models/beats.py``), likewise.

Counterpart of ``buzzdetect_tpu/models/registry.py``.
"""

import importlib.util
import json
import os
import threading

from buzzdetect_torch import config as cfg
from buzzdetect_torch.models import ast, beats
from buzzdetect_torch.models.classifier import (
    ChunkClassifier, resolve_conv, resolve_device)
from buzzdetect_torch.ops.frontend import FrontendConfig
from buzzdetect_torch.parallel.mesh import mesh_device


class BaseEmbedder:
    """Embedder contract: class attrs + ``initialize()`` + ``embed(samples)``.

    Attributes (parity with reference `src/inference/embedding.py:10-17`):
    ``embeddername, framelength_s, samplerate, n_embeddings, digits_time``.
    ``framehop_s`` derives from ``framelength_s * framehop_prop``.
    """

    embeddername: str = None
    framelength_s: float = None
    digits_time: int = None
    samplerate: int = None
    n_embeddings: int = None
    dtype_in = 'float32'
    # How far past a frame's start the embedder's DSP reads audio, BEYOND
    # framelength_s (e.g. an STFT window-completion tail). Watch mode uses
    # it to decide which finalized rows near a grown file's old EOF may
    # have scored zero padding and must be re-analyzed. ``None`` means
    # "undeclared" and is treated as a conservative full framelength —
    # plugin embedders with a tight tail should declare theirs to demote
    # (and re-score) fewer rows per growth.
    lookahead_s: float = None

    def __init__(self, framehop_prop: float = 1.0):
        self.framehop_prop = framehop_prop
        self.framehop_s = self.framelength_s * framehop_prop

    def initialize(self):
        raise NotImplementedError

    def embed(self, samples):
        raise NotImplementedError


class BaseModel:
    """Model contract: metadata at construction, weights on ``initialize()``,
    scores from ``predict(samples)`` (parity: `src/inference/models.py:12-37`)."""

    modelname: str = None
    embeddername: str = None
    digits_results: int = 2

    def __init__(self, dir_model: str, framehop_prop: float = 1.0):
        self.dir_model = dir_model
        self.framehop_prop = framehop_prop
        path_config = os.path.join(dir_model, 'config_model.json')
        with open(path_config) as f:
            self.config = json.load(f)
        self.embedder = load_embedder(
            self.config.get('embeddername', self.embeddername), framehop_prop)

    def initialize(self):
        raise NotImplementedError

    def predict(self, samples):
        raise NotImplementedError


class EmbedderYamnet(BaseEmbedder):
    """Native YAMNet embedder (frontend + MobileNet on one torch device).

    Supersedes both reference embedders: arbitrary ``framehop_prop`` is a
    graph parameter, covering `embedders/yamnet/embedder.py` (arbitrary hop,
    slow) and `embedders/yamnet_k2/embedder.py` (fast but only hop 1.0/0.5)
    with a single fast path.
    """

    embeddername = 'yamnet'
    framelength_s = 0.96
    digits_time = 2
    samplerate = 16000
    n_embeddings = 1024
    # STFT window-completion tail: the last 25 ms spectrogram window of a
    # patch reads window-hop = 15 ms past the patch's nominal end. 60 ms
    # (framelength/16) keeps 4x margin while demoting only ~1 row per
    # watch-mode growth; the BaseEmbedder default (a full framelength)
    # would demote every row within 1.92 s of the old EOF instead.
    lookahead_s = 0.06

    def __init__(self, framehop_prop: float = 1.0, arrays: dict = None,
                 device='cuda'):
        super().__init__(framehop_prop)
        # the graph's patch hop is a whole number of 10 ms spectrogram
        # frames; advertise THAT stride (snapped by with_framehop), not the
        # raw framelength*prop product, so writer timestamps and resume
        # coverage match the frames actually extracted (they diverge
        # whenever 96*framehop_prop is not an integer, e.g. prop=0.1)
        self.framehop_s = FrontendConfig().with_framehop(
            framehop_prop).patch_hop_seconds
        self._arrays = arrays
        self._device = device
        self._classifier = None
        self._init_lock = threading.Lock()

    def initialize(self):
        with self._init_lock:
            self._initialize_locked()

    def _initialize_locked(self):
        if self._classifier is not None:
            return
        arrays = self._arrays
        if arrays is None:
            # standalone use: a dedicated embedder bundle if installed,
            # otherwise the default model's bundle (it carries the same
            # yamnet weights; the head is simply ignored by embed())
            import numpy as np
            path = os.path.join(cfg.resolve_dir(cfg.DIR_EMBEDDERS), 'yamnet',
                                'embedder.npz')
            if not os.path.exists(path):
                path = os.path.join(cfg.resolve_dir(cfg.DIR_MODELS),
                                    cfg.DEFAULT_MODEL, 'model.npz')
            with np.load(path) as z:
                arrays = {k: z[k] for k in z.files}
        self._classifier = ChunkClassifier(arrays,
                                           framehop_prop=self.framehop_prop,
                                           device=self._device)

    def embed(self, samples):
        return self._classifier.embed(samples)


class EmbedderAST(BaseEmbedder):
    """The Audio Spectrogram Transformer's frame contract: windows of
    ``input_tdim`` 10 ms fbank frames (10.24 s at the published 1024), their
    hop ``framehop_prop`` of a window snapped to whole frames, and a
    look-ahead of one frame's tail (25 ms - 10 ms). Its scores come from
    :class:`ASTModel`; ``embed`` is not offered."""

    embeddername = 'ast'
    label = 'AST'
    digits_time = 2
    samplerate = 16000

    @staticmethod
    def _default_config():
        from buzzdetect_torch.models import ast
        return ast.ASTConfig()

    def __init__(self, framehop_prop: float = 1.0, cfg=None):
        from buzzdetect_torch.models.transformer import window_hop_frames
        from buzzdetect_torch.ops.logmel import HOP, WINDOW
        cfg = self._default_config() if cfg is None else cfg
        self.framelength_s = cfg.input_tdim * HOP / self.samplerate
        self.lookahead_s = (WINDOW - HOP) / self.samplerate
        self.n_embeddings = cfg.width
        super().__init__(framehop_prop)
        self.framehop_s = (window_hop_frames(cfg, framehop_prop) * HOP
                           / self.samplerate)

    def initialize(self):
        pass

    def embed(self, samples):
        raise NotImplementedError(f'the {self.label} model gives scores, not '
                                  f'embeddings; use predict()')


class EmbedderBEATs(EmbedderAST):
    """BEATs' frame contract, as :class:`EmbedderAST`'s with BEATs' windows
    (``input_tdim`` frames: 9.92 s at the port's 992). Its scores come from
    :class:`BEATsModel`."""

    embeddername = 'beats'
    label = 'BEATs'

    @staticmethod
    def _default_config():
        from buzzdetect_torch.models import beats
        return beats.BEATsConfig()


# 'yamnet_k2' resolves to the same native embedder: reference model configs
# name it (`models/model_general_v3/config_model.json`), and its only reason
# to exist — a faster restricted-framehop SavedModel — is moot here.
BUILTIN_EMBEDDERS = {
    'yamnet': EmbedderYamnet,
    'yamnet_k2': EmbedderYamnet,
    'ast': EmbedderAST,
    'beats': EmbedderBEATs,
}


class BundleModel(BaseModel):
    """Built-in model runner for ``model.npz`` bundles: the whole
    waveform->scores path runs on one device, or split over a mesh, via
    :class:`ChunkClassifier`."""

    def __init__(self, dir_model: str, framehop_prop: float = 1.0,
                 compute_dtype=None, sharding=None, mesh=None,
                 transfer_dtype=None, frontend=None, conv=None, device='cuda',
                 conv_precision=None):
        self.dir_model = dir_model
        self.framehop_prop = framehop_prop
        self.modelname = os.path.basename(dir_model.rstrip('/'))
        with open(os.path.join(dir_model, 'config_model.json')) as f:
            self.config = json.load(f)
        self.embeddername = self.config.get('embeddername', 'yamnet')
        self.digits_results = self.config.get('digits_results', 2)
        self._compute_dtype = compute_dtype
        self._sharding = sharding
        self._mesh = sharding.mesh if sharding is not None else mesh
        # resolved now, in the caller's thread: asking for CUDA without a
        # CUDA device, or a device= of another type than the mesh's,
        # raises here instead of inside an inferer thread
        self._device = resolve_device(
            device if self._mesh is None else mesh_device(self._mesh, device))
        # int16 wire format by default: source audio is 16-bit PCM, so this
        # is (near-)lossless and halves host->device traffic — the streaming
        # pipeline's bottleneck. An explicit per-run argument beats the
        # model config's default (a config pin must not silently override
        # the user's --transfer_dtype).
        self._transfer_dtype = (transfer_dtype
                                or self.config.get('transfer_dtype')
                                or 'int16')
        # frontend implementation: 'pallas' the fused log-mel kernel, 'xla'
        # the matmul frontend, 'auto' (default) the kernel on a card and the
        # matmul frontend elsewhere (classifier.resolve_frontend)
        self._frontend = frontend or self.config.get('frontend') or 'auto'
        # conv stack implementation: 'auto' (default) and 'pallas' run the
        # CUDA conv kernels at every compute dtype, 'xla' the XLA conv path;
        # a bad value raises here, in the caller's thread (ChunkClassifier
        # has the rules)
        self._conv = conv or self.config.get('conv') or 'auto'
        resolve_conv(self._conv, self._mesh)
        # conv-dot precision: 'auto' (default) resolves per conv path;
        # 'highest' runs exact f32, 'high' the emulated-HIGH mode of the
        # conv kernels (exact f32 on the XLA conv path)
        self._conv_precision = (conv_precision
                                or self.config.get('conv_precision')
                                or 'auto')
        self.classifier = None
        # one model instance is shared by every inferer thread; initialize()
        # must build the classifier exactly once
        self._init_lock = threading.Lock()
        # embedder metadata without loading weights twice: the bundle IS the
        # embedder; expose the contract attrs the pipeline needs
        self.embedder = EmbedderYamnet(framehop_prop, device=self._device)

    @property
    def device(self):
        """The torch device the model runs on."""
        return self._device

    @property
    def transfer_dtype(self):
        """Wire dtype for samples (streamers convert early so the
        quantization cost parallelizes across decode threads)."""
        return self._transfer_dtype

    def initialize(self):
        with self._init_lock:
            if self.classifier is not None:
                return
            import numpy as np
            with np.load(os.path.join(self.dir_model, 'model.npz')) as z:
                arrays = {k: z[k] for k in z.files}
            classifier = ChunkClassifier(
                arrays, framehop_prop=self.framehop_prop,
                compute_dtype=self._compute_dtype,
                transfer_dtype=self._transfer_dtype,
                frontend=self._frontend, conv=self._conv,
                device=self._device, conv_precision=self._conv_precision,
                sharding=self._sharding, mesh=self._mesh)
            self.embedder._classifier = classifier
            self.classifier = classifier

    # the classifier can ingest native-rate wire samples and resample
    # on-device (analyze(resample_on_device=True))
    supports_device_resample = True

    def predict(self, samples, input_rate=None):
        return self.classifier.predict(samples, input_rate=input_rate)

    def predict_async(self, samples, input_rate=None):
        return self.classifier.predict_async(samples, input_rate=input_rate)

    def predict_async_batch(self, samples_list, input_rate=None):
        return self.classifier.predict_async_batch(samples_list,
                                                   input_rate=input_rate)

    def warmup(self, chunk_samples: int):
        self.classifier.warmup(chunk_samples)


class TransformerModel(BundleModel):
    """A spectrogram transformer of a model directory whose
    ``config_model.json`` names its ``architecture``: its ``sizes`` (the
    architecture's configuration), its weights from ``model.npz`` where one
    is present, else, where the file says ``"weights": "seeded"``, from the
    architecture's ``seeded_params`` at its ``seed``. Class names are the
    file's ``classes``, or ``audioset_000`` .. where it has none. One device,
    the int16 wire by default; the YAMNet options (``frontend``, ``conv``, a
    mesh) are refused, and ``conv_precision`` may only say exact f32. A
    subclass names its ``architecture``, its configuration class, its
    classifier class, its ``seeded_params`` and its embedder class."""

    architecture = None
    label = None
    supports_device_resample = False
    config_class = classifier_class = embedder_class = None
    seeded_params = None

    def __init__(self, dir_model: str, framehop_prop: float = 1.0,
                 compute_dtype=None, sharding=None, mesh=None,
                 transfer_dtype=None, frontend=None, conv=None, device='cuda',
                 conv_precision=None):
        self.dir_model = dir_model
        self.framehop_prop = framehop_prop
        self.modelname = os.path.basename(dir_model.rstrip('/'))
        with open(os.path.join(dir_model, 'config_model.json')) as f:
            self.config = json.load(f)
        if self.config.get('architecture') != self.architecture:
            raise ValueError(f'{dir_model}: not an {self.label} model '
                             f'directory')
        if sharding is not None or mesh is not None:
            raise ValueError(f'the {self.label} model runs on one device: '
                             f'no mesh')
        if (frontend not in (None, 'auto') or conv not in (None, 'auto')
                or conv_precision not in (None, 'auto', 'highest')):
            raise ValueError(f'frontend, conv and conv_precision are YAMNet '
                             f'options; the {self.label} model takes none '
                             f'of them')
        self.model_config = self.config_class.from_sizes(self.config['sizes'])
        self.config.setdefault('classes', [
            f'audioset_{i:03d}' for i in range(self.model_config.label_dim)])
        self.embeddername = self.architecture
        self.digits_results = self.config.get('digits_results', 2)
        self._compute_dtype = compute_dtype
        self._sharding = self._mesh = None
        self._device = resolve_device(device)
        self._transfer_dtype = (transfer_dtype
                                or self.config.get('transfer_dtype')
                                or 'int16')
        self.classifier = None
        self._init_lock = threading.Lock()
        self.embedder = self.embedder_class(framehop_prop, self.model_config)

    def weights(self) -> dict:
        """The parameters: ``model.npz``, or the seeded ones."""
        import numpy as np
        path = os.path.join(self.dir_model, 'model.npz')
        if os.path.exists(path):
            with np.load(path) as z:
                return {k: z[k] for k in z.files}
        if self.config.get('weights') != 'seeded':
            raise FileNotFoundError(
                f'{self.dir_model}: no model.npz, and config_model.json does '
                f'not say "weights": "seeded"')
        return self.seeded_params(self.model_config, self.config['seed'])

    def initialize(self):
        with self._init_lock:
            if self.classifier is not None:
                return
            self.classifier = self.classifier_class(
                self.weights(), self.model_config,
                framehop_prop=self.framehop_prop,
                compute_dtype=self._compute_dtype, device=self._device,
                transfer_dtype=self._transfer_dtype)


class ASTModel(TransformerModel):
    """The Audio Spectrogram Transformer (``"architecture": "ast"``,
    ``models/ast.py``)."""

    architecture = 'ast'
    label = 'AST'

    config_class = ast.ASTConfig
    classifier_class = ast.ASTClassifier
    seeded_params = staticmethod(ast.seeded_params)
    embedder_class = EmbedderAST


class BEATsModel(TransformerModel):
    """BEATs (``"architecture": "beats"``, ``models/beats.py``)."""

    architecture = 'beats'
    label = 'BEATs'

    config_class = beats.BEATsConfig
    classifier_class = beats.BEATsClassifier
    seeded_params = staticmethod(beats.seeded_params)
    embedder_class = EmbedderBEATs


# the architectures a config_model.json may name
ARCHITECTURES = {'ast': ASTModel, 'beats': BEATsModel}


def _architecture(dir_model: str):
    """The ``architecture`` a model directory's ``config_model.json`` names,
    or None."""
    path = os.path.join(dir_model, 'config_model.json')
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f).get('architecture')


def _import_plugin(path_py: str, base_class):
    """Import a plugin module and instantiate its unique Base subclass."""
    name = f'buzzdetect_plugin_{abs(hash(path_py))}'
    spec = importlib.util.spec_from_file_location(name, path_py)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    subclasses = [obj for obj in vars(module).values()
                  if isinstance(obj, type) and issubclass(obj, base_class)
                  and obj is not base_class]
    if len(subclasses) != 1:
        raise ValueError(f'{path_py} must define exactly one '
                         f'{base_class.__name__} subclass '
                         f'(found {len(subclasses)})')
    return subclasses[0]


def _validate_embedder_contract(emb: BaseEmbedder, origin: str):
    """Enforce the plugin contract fields consumers trust blindly.

    ``lookahead_s`` feeds watch mode's demotion margin
    (analysis._demote_to_partial): a negative value would silently shrink
    the margin below the patch window and re-introduce the baked-padded-row
    bug the attribute exists to prevent, so it is rejected at load time.
    A declared lookahead LARGER than a full framelength is legal but almost
    certainly a unit mistake (the undeclared default is already a full
    framelength) — warn, don't block.
    """
    la = emb.lookahead_s
    if la is None:
        return emb
    la = float(la)
    if not (la >= 0.0):  # also catches NaN
        raise ValueError(
            f'{origin}: lookahead_s must be >= 0 (got {emb.lookahead_s!r}); '
            'a negative look-ahead would under-demote finalized rows in '
            'watch mode. Declare the true DSP read-ahead past a frame '
            'start beyond framelength_s, or leave it None for the '
            'conservative full-framelength default.')
    fl = emb.framelength_s
    if fl is not None and la > float(fl):
        import warnings
        warnings.warn(
            f'{origin}: lookahead_s={la} exceeds framelength_s={fl}; the '
            'undeclared default is already a full framelength, so a larger '
            'value only demotes extra finalized rows per watch-mode growth '
            '(check the units)', RuntimeWarning)
    return emb


def load_embedder(embeddername: str, framehop_prop: float = 1.0) -> BaseEmbedder:
    """Resolve an embedder: ``embedders/<name>/embedder.py`` plugin first,
    then the built-in registry."""
    dir_emb = os.path.join(cfg.resolve_dir(cfg.DIR_EMBEDDERS), embeddername)
    path_py = os.path.join(dir_emb, 'embedder.py')
    if os.path.exists(path_py):
        klass = _import_plugin(path_py, BaseEmbedder)
        return _validate_embedder_contract(
            klass(framehop_prop=framehop_prop), path_py)
    if embeddername in BUILTIN_EMBEDDERS:
        return BUILTIN_EMBEDDERS[embeddername](framehop_prop=framehop_prop)
    raise FileNotFoundError(
        f'no embedder named "{embeddername}" (no plugin at {path_py}, not a '
        f'built-in)')


def load_model(modelname: str, framehop_prop: float = 1.0,
               initialize: bool = False, compute_dtype=None,
               sharding=None, mesh=None,
               transfer_dtype=None, frontend=None, conv=None, device='cuda',
               conv_precision=None) -> BaseModel:
    """Resolve a model by directory name.

    ``models/<name>/config_model.json`` naming ``"architecture": "ast"`` or
    ``"beats"`` -> ASTModel or BEATsModel on ``device``;
    ``models/<name>/model.npz`` -> built-in BundleModel on ``device``, or
    over ``mesh`` (of ``device``'s type);
    otherwise ``models/<name>/model.py`` -> user plugin class.
    ``initialize=False`` loads metadata only (config, embedder attrs) — used
    by the orchestrator for chunk-length math before workers spin up.
    """
    dir_model = os.path.join(cfg.resolve_dir(cfg.DIR_MODELS), modelname)
    if not os.path.isdir(dir_model):
        raise FileNotFoundError(f'no model directory: {dir_model}')

    architecture = ARCHITECTURES.get(_architecture(dir_model))
    if architecture is not None:
        model = architecture(dir_model, framehop_prop,
                         compute_dtype=compute_dtype, sharding=sharding,
                         mesh=mesh, transfer_dtype=transfer_dtype,
                         frontend=frontend, conv=conv, device=device,
                         conv_precision=conv_precision)
    elif os.path.exists(os.path.join(dir_model, 'model.npz')):
        model = BundleModel(dir_model, framehop_prop,
                            compute_dtype=compute_dtype, sharding=sharding,
                            mesh=mesh, transfer_dtype=transfer_dtype,
                            frontend=frontend, conv=conv, device=device,
                            conv_precision=conv_precision)
    elif os.path.exists(os.path.join(dir_model, 'model.py')):
        klass = _import_plugin(os.path.join(dir_model, 'model.py'), BaseModel)
        model = klass(dir_model, framehop_prop)
    else:
        raise FileNotFoundError(
            f'model "{modelname}" has neither model.npz nor model.py')

    if initialize:
        model.initialize()
    return model
