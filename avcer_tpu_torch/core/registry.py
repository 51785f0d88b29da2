"""Label-space contracts and published constants: the port's own copy of
avcer_tpu/core/registry.py (numpy only), pinned against it constant by
constant in tests/test_torch_ops.py.

The reference scatters these across hard-coded dicts and matrices. Parity
citations (paths are the reference repository's):

- video emotion order:       src/get_prob_video.py:56-64
- audio / fusion order:      src/get_prob_audio_8_cl.py:104-123,
                             src/run.py:56-65
- compound pairs:            src/run.py:66-74
- emotion prior weights:     src/run.py:116-123
- published AV weights:      src/run.py:316-344 (3x7)
- published matrices (V/AV): src/get_weights_matrices.py:5-62
- VGGFace2 channel means:    src/data/utils.py:27-29
- RetinaFace input means:    .../retina_face/retina_face_predictor.py:64
"""

from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# Emotion label spaces
# ---------------------------------------------------------------------------

#: Order the visual (static ResNet50 / dynamic LSTM) models emit.
VIDEO_EMOTIONS: tuple[str, ...] = (
    "Neutral", "Happiness", "Sadness", "Surprise", "Fear", "Disgust", "Anger",
)

#: Order the audio models emit and the fusion stage works in (8-class adds
#: trailing "Other"). All compound-pair indices index THIS order.
AUDIO_EMOTIONS_7: tuple[str, ...] = (
    "Neutral", "Anger", "Disgust", "Fear", "Happiness", "Sadness", "Surprise",
)
AUDIO_EMOTIONS_8: tuple[str, ...] = AUDIO_EMOTIONS_7 + ("Other",)

#: Permutation taking a row in video order to fusion (audio) order:
#: fusion_row[j] = video_row[VIDEO_TO_FUSION[j]].  The reference does this
#: implicitly via pandas column-name selection (src/run.py:85-87);
#: we make it an explicit gather.
VIDEO_TO_FUSION: tuple[int, ...] = tuple(
    VIDEO_EMOTIONS.index(e) for e in AUDIO_EMOTIONS_7
)

# ---------------------------------------------------------------------------
# Compound expressions
# ---------------------------------------------------------------------------

#: Compound class -> (idx_1, idx_2) into AUDIO_EMOTIONS_7.
COMPOUND_PAIRS: dict[str, tuple[int, int]] = {
    "Fearfully Surprised": (3, 6),
    "Happily Surprised": (4, 6),
    "Sadly Surprised": (5, 6),
    "Disgustedly Surprised": (2, 6),
    "Angrily Surprised": (1, 6),
    "Sadly Fearful": (3, 5),
    "Sadly Angry": (1, 5),
}

COMPOUND_NAMES: tuple[str, ...] = tuple(COMPOUND_PAIRS)

#: Column header used in challenge txt submissions
#: (src/run.py:170-179).
COMPOUND_TXT_COLUMNS: tuple[str, ...] = ("image_location",) + tuple(
    n.replace(" ", "_") for n in COMPOUND_NAMES
)

#: Per-basic-emotion prior weight used by fusion Rule 2
#: (src/run.py:116-123). Index into AUDIO_EMOTIONS_7.
EMOTION_PRIOR_WEIGHTS: dict[int, float] = {1: 5, 2: 6, 3: 5, 4: 6, 5: 4, 6: 2}

#: Rule 1 mask threshold (src/data/utils.py:239).
RULE1_MASK_THRESHOLD: float = 1.0 / 7.0


def compound_index_arrays() -> tuple[np.ndarray, np.ndarray]:
    """(idx_1[K], idx_2[K]) int arrays for the K compound classes."""
    pairs = np.asarray(list(COMPOUND_PAIRS.values()), dtype=np.int32)
    return pairs[:, 0], pairs[:, 1]


def rule2_pair_weights() -> tuple[np.ndarray, np.ndarray]:
    """Pair-normalized Rule-2 weights (w1[K], w2[K]) per compound class.

    w_i = prior[idx_i] / (prior[idx_1] + prior[idx_2])
    (src/data/utils.py:228-233).
    """
    i1, i2 = compound_index_arrays()
    p = EMOTION_PRIOR_WEIGHTS
    s = np.array([p[int(a)] + p[int(b)] for a, b in zip(i1, i2)], dtype=np.float64)
    w1 = np.array([p[int(a)] for a in i1], dtype=np.float64) / s
    w2 = np.array([p[int(b)] for b in i2], dtype=np.float64) / s
    return w1, w2


# ---------------------------------------------------------------------------
# Published fusion weight matrices
# ---------------------------------------------------------------------------

#: Dirichlet-optimized per-(model, emotion) weights for the flagship AV run,
#: rows = (static visual, dynamic visual, audio), cols = AUDIO_EMOTIONS_7
#: (src/run.py:316-344).
AV_WEIGHTS_8CL: np.ndarray = np.array(
    [
        [0.89900098, 0.10362151, 0.08577635, 0.04428126, 0.89679865, 0.02656456, 0.63040305],
        [0.01223291, 0.21364307, 0.66688002, 0.93791526, 0.0398964, 0.48670648, 0.22089692],
        [0.08876611, 0.68273542, 0.24734363, 0.01780348, 0.06330495, 0.48672896, 0.14870002],
    ],
    dtype=np.float64,
)

#: Published video-only (VS, VD) weights, rows = emotions in fusion order
#: plus the "Mouth open" auxiliary row (src/
#: get_weights_matrices.py:5-16).
V_WEIGHTS: np.ndarray = np.array(
    [
        [0.42633145, 0.57366855],
        [0.57803352, 0.42196648],
        [0.01878466, 0.98121534],
        [0.86451425, 0.13548575],
        [0.16464752, 0.83535248],
        [0.03786653, 0.96213347],
        [0.81048546, 0.18951454],
        [0.36499999999999994, 0.22999999999999998],
    ],
    dtype=np.float64,
)

#: Published AV weights for the 7-class audio front-end (VS, VD, A),
#: rows = emotions + "Mouth open" row (get_weights_matrices.py:28-39).
AV_WEIGHTS_7CL: np.ndarray = np.array(
    [
        [0.85806901, 0.11491265, 0.02701833],
        [0.2579578, 0.46222294, 0.27981925],
        [0.2579578, 0.62411413, 0.17148297],
        [0.72010502, 0.16716238, 0.1127326],
        [0.62082661, 0.31962795, 0.05954545],
        [0.06281922, 0.16603196, 0.77114883],
        [0.70875895, 0.24433032, 0.04691073],
        [0.060000000000000005, 0.21000000000000002, 0.01],
    ],
    dtype=np.float64,
)

# ---------------------------------------------------------------------------
# Image preprocessing constants
# ---------------------------------------------------------------------------

#: VGGFace2 per-channel (B, G, R) means subtracted after the RGB->BGR flip
#: (src/data/utils.py:27-29).
VGGFACE2_BGR_MEAN: tuple[float, float, float] = (91.4953, 103.8827, 131.0912)

#: RetinaFace preprocessing BGR means
#: (.../retina_face/retina_face_predictor.py:64).
RETINAFACE_BGR_MEAN: tuple[float, float, float] = (104.0, 117.0, 123.0)

#: Emotion CNN input resolution (src/data/utils.py:32).
FACE_INPUT_SIZE: int = 224

#: Dynamic model temporal window length (src/get_prob_video.py:117-120).
LSTM_WINDOW: int = 10

# ---------------------------------------------------------------------------
# Audio constants
# ---------------------------------------------------------------------------

SAMPLE_RATE: int = 16_000
AUDIO_WINDOW_SEC: float = 4.0
AUDIO_STEP_SEC: float = 0.5


def dynamic_step(fps: float) -> int:
    """Frame stride of the dynamic model (src/get_prob_video.py:77)."""
    return max(1, round((5 * fps) / 25))
