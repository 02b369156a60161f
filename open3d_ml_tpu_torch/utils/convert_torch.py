"""Load the reference's PyTorch checkpoints into the port's networks.

Counterpart of ``open3d_ml_tpu/utils/convert_torch.py``, which maps a
reference ``state_dict`` onto the JAX package's flax variables. Here each
converter maps the reference's keys straight onto the port's parameter
and buffer names (those of the flax tree, see ``utils/convert_jax.py``),
so that a strict ``load_state_dict`` of the port's net takes the result.
A converter is a table of renames (``rename``), applied to every key in
order, and a reshape where the two layouts differ:

* a 1x1 ``Conv1d``/``Conv2d`` weight [out, in, 1(, 1)] where the port
  has a Linear -> ``weight [out, in]`` (RandLA-Net, PointRCNN, PVCNN);
  RandLA-Net's 1x1 ``ConvTranspose2d`` weight [in, out, 1, 1] -> Linear
  ``weight [out, in]``;
* a sparse convolution's kernel [d, h, w, Cin, Cout] -> ``[K, Cin,
  Cout]`` (z-major, x fastest; ``spatial_axes="xyz"`` for a checkpoint
  stored x-major);
* every other tensor as it is: Linear, ``Conv2d``, ``ConvTranspose2d``
  (PointPillars) and ``Conv3d`` (PVCNN) weights, KPConv's ``weights [P,
  Cin, Cout]``, and its ``kernel_points`` buffers, which replace the
  kernel points the port's net draws (Lloyd's);
* BatchNorm ``weight``, ``bias``, ``running_mean`` and ``running_var``
  keep their names under the port's module path. The reference's
  ``num_batches_tracked`` is dropped, and where the port's layer counts
  batches (every net's but SparseConvUnet's ``MaskedBatchNorm``) it is 0:
  the port's layers run at a fixed momentum and never read it.

A key that no rule renames keeps its name; a strict load reports any that
the port's net lacks. ``convert_checkpoint`` dispatches on the model's
name as the JAX one does, with no entry for PointRCNN (call
``convert_pointrcnn``).
"""

import re

import numpy as np
import torch

_COUNT = "num_batches_tracked"


def _rule(reference, port, scale=1, shift=0):
    """A rename of a dotted piece of a key, the reference's ``reference``
    <-> the port's ``port``; each ``{}`` is an index, and the last one is
    ``scale * port's + shift`` on the reference's side (a slot of a
    Sequential, a list built in reverse)."""
    return reference, port, scale, shift


def _pattern(piece):
    """``piece`` as a regex that matches at the start of a dotted
    component, each ``{}`` an index."""
    return re.compile(r"(?:^|(?<=\.))" +
                      re.escape(piece).replace(r"\{\}", r"(\d+)"))


def rename(key, rules, inverse=False):
    """``key`` (the reference's, or the port's with ``inverse``) with each
    of ``rules`` applied in order, each once, where it matches."""
    for reference, port, scale, shift in rules:
        src, dst = (port, reference) if inverse else (reference, port)
        match = _pattern(src).search(key)
        if match is None:
            continue
        index = [int(g) for g in match.groups()]
        if index and inverse:
            index[-1] = scale * index[-1] + shift
        elif index:
            last, rest = divmod(index[-1] - shift, scale)
            if rest:
                continue
            index[-1] = last
        key = key[:match.start()] + dst.format(*index) + key[match.end():]
    return key


def _squeezed(value):
    """A 1x1 convolution's weight [out, in, 1(, 1)] -> [out, in]; any other
    tensor as it is."""
    if value.ndim in (3, 4) and all(d == 1 for d in value.shape[2:]):
        return value.reshape(value.shape[:2])
    return value


def _convert(state_dict, rules, reshape=lambda key, value: value,
             counted=True):
    """The reference's ``state_dict`` -> the port's, each key renamed by
    ``rules`` and each value passed through ``reshape(reference key,
    float32 array)``; a ``num_batches_tracked`` of 0 beside each running
    mean where the port's BatchNorms count batches (``counted``)."""
    out = {}
    for key, value in state_dict.items():
        if key.endswith(_COUNT):
            continue
        value = reshape(key, np.asarray(value, np.float32))
        out[rename(key, rules)] = torch.tensor(value)
    if counted:
        for key in list(out):
            if key.endswith(".running_mean"):
                out[key[:-len("running_mean")] + _COUNT] = torch.tensor(0)
    return out


RANDLANET_NAMES = (
    _rule("encoder.{}.", "encoder_{}."),
    _rule("score_fn.0.", "score_fn."),
    _rule("decoder.{}.", "decoder_{}."),
    _rule("fc1.{}.", "fc1_{}."))


def convert_randlanet(state_dict):
    """A reference RandLANet ``state_dict`` (``fc0``/``bn0``, ``encoder.{i}``
    with ``mlp1``, ``lse{1,2}``, ``pool{1,2}``, ``mlp2``, ``shortcut``;
    ``mlp``; ``decoder.{i}`` 1x1 transposed convolutions; ``fc1``) -> the
    port's ``RandLANetNet`` state_dict (``encoder_{i}``, ``decoder_{i}``,
    ``fc1_{0,1,3}``)."""
    def reshape(key, value):
        if key.startswith("decoder.") and value.ndim == 4:
            return value[:, :, 0, 0].T
        return _squeezed(value)
    return _convert(state_dict, RANDLANET_NAMES, reshape)


# the reference's SECOND backbone holds [Conv2d, BatchNorm, ReLU] runs in
# one Sequential a stage, its SECONDFPN neck [ConvTranspose2d, BatchNorm,
# ReLU] a stage
POINTPILLARS_NAMES = (
    _rule("voxel_encoder.pfn_layers.{}.", "voxel_encoder.pfn_{}."),
    _rule("backbone.blocks.{}.{}.", "backbone.block{}_conv{}.", 3, 0),
    _rule("backbone.blocks.{}.{}.", "backbone.block{}_bn{}.", 3, 1),
    _rule("neck.deblocks.{}.0.", "neck.deblock{}_up."),
    _rule("neck.deblocks.{}.1.", "neck.deblock{}_bn."),
    _rule("bbox_head.conv_", "conv_"))


def convert_pointpillars(state_dict):
    """A reference PointPillars ``state_dict`` (``voxel_encoder.pfn_layers``,
    ``backbone.blocks``, ``neck.deblocks``, ``bbox_head``) -> the port's
    ``PointPillarsNet`` state_dict (``voxel_encoder.pfn_{i}``,
    ``backbone.block{i}_{conv,bn}{j}``, ``neck.deblock{i}_{up,bn}``, the
    head's three convolutions, whose channels keep the reference's
    [anchor * attribute] order); every tensor as it is."""
    return _convert(state_dict, POINTPILLARS_NAMES)


def convert_kpfcnn(state_dict):
    """A reference KPFCNN ``state_dict`` (``encoder_blocks`` and
    ``decoder_blocks`` ModuleLists, ``head_mlp``, ``head_softmax``) -> the
    port's ``KPFCNNNet`` state_dict, block ``i`` at ``enc{i}``/``dec{i}``
    on both sides. A block's ``BatchNormBlock`` (its BatchNorm, or its
    bias without one) becomes ``unary_bn``/``unary_bias`` beside an
    ``mlp`` (a unary block), ``conv_bn``/``conv_bias`` as a ResNet block's
    ``batch_norm_conv``, else ``simple_bn``/``simple_bias``. Each KPConv's
    ``weights`` are as they are, and its ``kernel_points`` buffer is the
    checkpoint's, not the Lloyd points the port's net draws."""
    unaries = sorted(k[:-len(".mlp.weight")] for k in state_dict
                     if k.endswith(".mlp.weight"))
    rules = [_rule(f"{u}.batch_norm.{leaf}", f"{u}.unary_{name}")
             for u in unaries
             for leaf, name in (("batch_norm.", "bn."), ("bias", "bias"))]
    rules += [_rule("batch_norm_conv.batch_norm.", "conv_bn."),
              _rule("batch_norm_conv.bias", "conv_bias"),
              _rule("batch_norm.batch_norm.", "simple_bn."),
              _rule("batch_norm.bias", "simple_bias"),
              _rule("kernel_points", "points"),
              _rule("encoder_blocks.{}.", "enc{}."),
              _rule("decoder_blocks.{}.", "dec{}.")]
    return _convert(state_dict, rules)


def _sparse_kernel(value, spatial_axes="zyx"):
    """A sparse convolution's kernel [d, h, w, Cin, Cout] -> [K, Cin, Cout]
    in the port's offset order (z-major, x fastest: a C-order flatten of a
    [z][y][x] kernel); ``spatial_axes="xyz"`` reverses the spatial axes
    first for a checkpoint stored x-major."""
    if value.ndim != 5:
        return value
    if spatial_axes == "xyz":
        value = value.transpose(2, 1, 0, 3, 4)
    return value.reshape(-1, value.shape[-2], value.shape[-1])


def _sparseconvunet_names(num_levels, conv_block_reps, residual_blocks):
    """The renames of the reference's recursive U, flattened into
    ``unet.net.{i}``, walked as the reference builds it (its
    ``get_UNet``)."""
    rules = []
    idx = [0]  # the flat unet.net index, shared by the recursion

    def take(piece=None, port=None):
        if port is not None:
            rules.append(_rule(f"unet.net.{idx[0]}.{piece}", port))
        idx[0] += 1

    def block(name):
        if residual_blocks:
            take("", name + ".")  # ResidualBlock
        else:
            take("", name + ".")  # BatchNormBlock: its .bn
            take()  # ReLUBlock
            take("", name + ".conv.")  # SubmanifoldSparseConv

    def walk(level):
        for r in range(conv_block_reps):
            block(f"l{level}_block{r}")
        if level == num_levels - 1:
            return
        take()  # ConcatFeat
        take("bn.", f"l{level}_down_bn.")
        take()  # ReLU
        take("net.kernel", f"l{level}_down_kernel")  # kernel 2, stride 2
        walk(level + 1)
        take("bn.", f"l{level}_up_bn.")
        take()  # ReLU
        take("net.kernel", f"l{level}_up_kernel")  # DeConvolution
        take()  # JoinFeat
        for r in range(conv_block_reps):
            block(f"l{level}_post{r}")

    walk(0)
    return rules + [_rule("sub_sparse_conv.", "input_conv."),
                    _rule("batch_norm.bn.", "final_bn."),
                    _rule("linear.linear.", "linear."),
                    _rule("lin.linear.", "lin."),
                    _rule("batch_norm{}.bn.", "bn{}."),
                    _rule("sub_sparse_conv{}.", "conv{}."),
                    _rule("net.kernel", "weight")]


def convert_sparseconvunet(state_dict, num_levels=7, conv_block_reps=1,
                           residual_blocks=False, spatial_axes="zyx"):
    """A reference SparseConvUnet ``state_dict`` (the recursive U flattened
    into ``unet.net.{i}``, ``sub_sparse_conv``, ``batch_norm``,
    ``linear``) -> the port's ``SparseConvUnetNet`` state_dict, walking
    the same recursion (``l{L}_block{r}``/``_post{r}``, ``l{L}_down_*``/
    ``_up_*``); the sparse convolutions' ``offset`` buffers (geometry) are
    dropped, and its ``MaskedBatchNorm`` layers count no batches."""
    rules = _sparseconvunet_names(num_levels, conv_block_reps,
                                  residual_blocks)
    kept = {k: v for k, v in state_dict.items()
            if not k.endswith(".net.offset")}
    return _convert(kept, rules,
                    lambda key, value: _sparse_kernel(value, spatial_axes),
                    counted=False)


POINTTRANSFORMER_NAMES = (
    _rule("encoders.{}.0.", "enc{}_down."),
    _rule("encoders.{}.{}.", "enc{}_block{}."),
    # the reference builds its decoders from level 4 down
    _rule("decoders.{}.0.", "dec{}_up.", -1, 4),
    _rule("decoders.{}.1.", "dec{}_block1.", -1, 4),
    _rule("linear1.0.", "linear1."),
    _rule("linear1.1.", "bn1."),
    _rule("linear2.0.", "linear2."),
    _rule("linear2.1.", "bn2."),
    _rule("linear_p.0.", "linear_p0."),
    _rule("linear_p.1.", "linear_p_bn."),
    _rule("linear_p.3.", "linear_p1."),
    _rule("linear_w.0.", "linear_w_bn0."),
    _rule("linear_w.2.", "linear_w0."),
    _rule("linear_w.3.", "linear_w_bn1."),
    _rule("linear_w.5.", "linear_w1."),
    _rule("cls.0.", "cls0."),
    _rule("cls.1.", "cls_bn."),
    _rule("cls.3.", "cls1."))


def convert_pointtransformer(state_dict):
    """A reference PointTransformer ``state_dict`` (``encoders.{i}`` =
    [TransitionDown, Bottleneck x (blocks[i] - 1)], ``decoders.{4 - i}``,
    ``cls``) -> the port's ``PointTransformerNet`` state_dict
    (``enc{i}_down``/``_block{b}``, ``dec{i}_up``/``_block1``, ``cls0``,
    ``cls_bn``, ``cls1``; the Transformer's Sequentials ``linear_p.{0,1,3}``
    and ``linear_w.{0,2,3,5}`` as ``linear_p0``, ``linear_p_bn``,
    ``linear_p1`` and ``linear_w_bn0``, ``linear_w0``, ``linear_w_bn1``,
    ``linear_w1``)."""
    return _convert(state_dict, POINTTRANSFORMER_NAMES)


def convert_pointrcnn(state_dict):
    """A reference PointRCNN ``state_dict`` (the RPN: Pointnet2MSG's
    ``SA_modules``/``FP_modules`` and the ``cls_blocks``/``reg_blocks``
    heads; the RCNN: ``xyz_up_layer``, ``merge_down_layer``,
    ``SA_modules`` and the two heads) -> the port's ``PointRCNNNet``
    state_dict (``rpn.backbone.sa{i}.mlp{j}.conv{k}``/``bn{k}``, ...). A
    head's Sequential is [Conv1d, BatchNorm, ReLU, Dropout] runs (the
    RPN's) or [Conv1d, ReLU] runs (the RCNN's), then its ``final``
    convolution, the one of the highest slot. ``convert_checkpoint`` has
    no entry for it, as in JAX."""
    rules = []
    for head, stride in (("rpn.cls_blocks", 4), ("rpn.reg_blocks", 4),
                         ("rcnn.cls_blocks", 2), ("rcnn.reg_blocks", 2)):
        slots = [int(m[1]) for k in state_dict
                 if (m := re.fullmatch(re.escape(head) + r"\.(\d+)\.weight",
                                       k))]
        if slots:
            rules.append(_rule(f"{head}.{max(slots)}.", f"{head}.final."))
        rules += [_rule(head + ".{}.", head + ".conv{}.", stride, 0),
                  _rule(head + ".{}.", head + ".bn{}.", stride, 1)]
    rules += [_rule("SA_modules.{}.mlps.{}.", "sa{}.mlp{}."),
              _rule("FP_modules.{}.", "fp{}."),
              _rule("layer{}.conv.", "conv{}."),
              _rule("layer{}.bn.bn.", "bn{}."),
              _rule("xyz_up_layer.{}.", "xyz_up_layer.conv{}.", 2, 0),
              _rule("merge_down_layer.0.", "merge_down_layer.conv0.")]
    return _convert(state_dict, rules, lambda key, value: _squeezed(value))


PVCNN_NAMES = (
    _rule("point_features.{}.voxel_layers.0.", "pf{}.vconv0."),
    _rule("point_features.{}.voxel_layers.1.", "pf{}.vbn0."),
    _rule("point_features.{}.voxel_layers.3.", "pf{}.vconv1."),
    _rule("point_features.{}.voxel_layers.4.", "pf{}.vbn1."),
    _rule("point_features.{}.", "pf{}."),
    _rule("cloud_features.{}.0.", "cloud{}."),
    _rule("cloud_features.{}.1.", "cloud_bn{}."),
    _rule("classifier.0.", "cls0."),
    _rule("classifier.2.", "cls1."),
    _rule("classifier.4.", "cls2."),
    _rule("layers.0.", "dense_0."),
    _rule("layers.1.", "bn_0."))


def convert_pvcnn(state_dict):
    """A reference PVCNN ``state_dict`` (``point_features`` a ModuleList of
    PVConv and SharedMLP blocks, ``cloud_features`` and ``classifier``
    Sequentials; ``with_se=False``, as the reference builds it) -> the
    port's ``PVCNNNet`` state_dict:

    * ``point_features.{i}.voxel_layers.{0, 3}`` (Conv3d) and ``.{1, 4}``
      (BatchNorm) -> ``pf{i}.vconv{0, 1}`` and ``pf{i}.vbn{0, 1}``;
    * a SharedMLP's ``layers.0`` (1x1 Conv1d) and ``layers.1``
      (BatchNorm) -> ``dense_0`` and ``bn_0`` (a PVConv's under
      ``point_features``, the last block's under ``pf{i}``);
    * ``cloud_features.{j}.0`` and ``.1`` -> ``cloud{j}`` and
      ``cloud_bn{j}``;
    * ``classifier.0`` and ``.2`` (SharedMLPs) -> ``cls0`` and ``cls1``,
      ``classifier.4`` (1x1 Conv1d) -> ``cls2``.

    Widths are read from the tensors, so any width multiplier converts."""
    return _convert(state_dict, PVCNN_NAMES,
                    lambda key, value: _squeezed(value))


def load_torch_checkpoint(path):
    """A ``.pth`` checkpoint's model state dict (its
    ``model_state_dict``, or the file itself) as numpy arrays. The file
    is read by torch's weights-only unpickler (tensors, containers and
    numbers), so a file that holds other objects raises rather than runs
    code of its own."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt.get("model_state_dict", ckpt)
    return {k: v.detach().cpu().numpy() for k, v in sd.items()}


# the JAX package's dispatch, name for name
CONVERTERS = {"RandLANet": convert_randlanet,
              "PointPillars": convert_pointpillars,
              "KPFCNN": convert_kpfcnn,
              "KPConv": convert_kpfcnn,
              "SparseConvUnet": convert_sparseconvunet,
              "PointTransformer": convert_pointtransformer,
              "PVCNN": convert_pvcnn}


def convert_checkpoint(path, model_name="RandLANet", **kwargs):
    """A reference ``.pth`` -> the port's state_dict for ``model_name``;
    ``kwargs`` go to the converter."""
    sd = load_torch_checkpoint(path)
    if model_name not in CONVERTERS:
        raise NotImplementedError(
            f"No torch-checkpoint converter for {model_name} yet "
            f"(available: {sorted(CONVERTERS)})")
    return CONVERTERS[model_name](sd, **kwargs)
