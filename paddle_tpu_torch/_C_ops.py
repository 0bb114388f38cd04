"""`_C_ops` of the port: the op-binding namespace (`paddle_tpu/_C_ops.py`;
reference `python/paddle/_C_ops.py`, the pybind functions
`python_c_gen.py:119` emits).

A copy of the JAX package's generated module: the same 343 names, the same
signatures (the reference yaml's argument order and names, e.g.
`_C_ops.matmul(x, y, False, False)`) and the same bodies, which forward to
the public API, renaming to its spellings and dropping kernel-only
arguments. Only the resolver `_t` differs: it resolves `_TARGETS` against
`paddle_tpu_torch`. The targets in namespaces the port has not ported yet
(`geometric`, `signal`, `text`, ROADMAP A10g) raise NotImplementedError naming their slice when called,
not when this module is imported.
"""

# fmt: off
# flake8: noqa

_cache = {}

# the namespaces of `_TARGETS` a later slice ports
_LATER = {
    'paddle.geometric.': 'A10g',
    'paddle.signal.': 'A10g',
    'paddle.text.': 'A10g',
}


def _t(name):
    fn = _cache.get(name)
    if fn is None:
        target = _TARGETS[name]
        for prefix, slice_id in _LATER.items():
            if target.startswith(prefix):
                raise NotImplementedError(
                    f"_C_ops.{name} calls {target}, which is ported with "
                    f"ROADMAP {slice_id}")
        import paddle_tpu_torch as paddle
        import paddle_tpu_torch.nn.functional as F  # noqa: F401 (eval namespace)

        fn = _cache[name] = eval(target)
    return fn


_TARGETS = {
    'abs': 'paddle.abs',
    'accuracy_check': 'paddle.accuracy_check',
    'acos': 'paddle.acos',
    'acosh': 'paddle.acosh',
    'add_position_encoding': 'paddle.add_position_encoding',
    'addmm': 'paddle.addmm',
    'affine_channel': 'paddle.affine_channel',
    'affine_grid': 'paddle.nn.functional.affine_grid',
    'all': 'paddle.all',
    'allclose': 'paddle.allclose',
    'amax': 'paddle.amax',
    'amin': 'paddle.amin',
    'angle': 'paddle.angle',
    'any': 'paddle.any',
    'apply_per_channel_scale': 'paddle.quantization.apply_per_channel_scale',
    'arange': 'paddle.arange',
    'argmax': 'paddle.argmax',
    'argmin': 'paddle.argmin',
    'argsort': 'paddle.argsort',
    'as_complex': 'paddle.as_complex',
    'as_real': 'paddle.as_real',
    'as_strided': 'paddle.as_strided',
    'asin': 'paddle.asin',
    'asinh': 'paddle.asinh',
    'assign': 'paddle.assign',
    'atan': 'paddle.atan',
    'atan2': 'paddle.atan2',
    'atanh': 'paddle.atanh',
    'baddbmm': 'paddle.baddbmm',
    'batch_fc': 'paddle.batch_fc',
    'beam_search': 'paddle.beam_search',
    'beam_search_decode': 'paddle.beam_search_decode',
    'bernoulli': 'paddle.bernoulli',
    'bilinear': 'paddle.nn.functional.bilinear',
    'bincount': 'paddle.bincount',
    'binomial': 'paddle.binomial',
    'bipartite_match': 'paddle.vision.ops.bipartite_match',
    'bitwise_and': 'paddle.bitwise_and',
    'bitwise_left_shift': 'paddle.bitwise_left_shift',
    'bitwise_not': 'paddle.bitwise_not',
    'bitwise_or': 'paddle.bitwise_or',
    'bitwise_right_shift': 'paddle.bitwise_right_shift',
    'bitwise_xor': 'paddle.bitwise_xor',
    'bmm': 'paddle.bmm',
    'box_clip': 'paddle.vision.ops.box_clip',
    'box_coder': 'paddle.vision.ops.box_coder',
    'broadcast_tensors': 'paddle.broadcast_tensors',
    'cast': 'paddle.cast',
    'ceil': 'paddle.ceil',
    'celu': 'paddle.nn.functional.celu',
    'channel_shuffle': 'paddle.nn.functional.channel_shuffle',
    'cholesky': 'paddle.cholesky',
    'cholesky_solve': 'paddle.cholesky_solve',
    'chunk_eval': 'paddle.chunk_eval',
    'class_center_sample': 'paddle.class_center_sample',
    'clip': 'paddle.clip',
    'clip_by_norm': 'paddle.clip_by_norm',
    'collect_fpn_proposals': 'paddle.vision.ops.collect_fpn_proposals',
    'complex': 'paddle.complex',
    'concat': 'paddle.concat',
    'conj': 'paddle.conj',
    'conv2d': 'paddle.nn.functional.conv2d',
    'conv2d_transpose': 'paddle.nn.functional.conv2d_transpose',
    'conv3d': 'paddle.nn.functional.conv3d',
    'conv3d_transpose': 'paddle.nn.functional.conv3d_transpose',
    'copysign': 'paddle.copysign',
    'correlation': 'paddle.vision.ops.correlation',
    'cos': 'paddle.cos',
    'cosh': 'paddle.cosh',
    'crf_decoding': 'paddle.crf_decoding',
    'crop': 'paddle.crop',
    'cross': 'paddle.cross',
    'cross_entropy': 'paddle.nn.functional.cross_entropy',
    'ctc_align': 'paddle.ctc_align',
    'cummax': 'paddle.cummax',
    'cummin': 'paddle.cummin',
    'cumprod': 'paddle.cumprod',
    'cumsum': 'paddle.cumsum',
    'cvm': 'paddle.cvm',
    'decode_jpeg': 'paddle.vision.ops.decode_jpeg',
    'deformable_conv': 'paddle.vision.ops.deformable_conv',
    'det': 'paddle.det',
    'dgc': 'paddle.dgc',
    'dgc_clip_by_norm': 'paddle.dgc_clip_by_norm',
    'dgc_momentum': 'paddle.dgc_momentum',
    'diag': 'paddle.diag',
    'diag_embed': 'paddle.diag_embed',
    'diagonal': 'paddle.diagonal',
    'digamma': 'paddle.digamma',
    'dist': 'paddle.dist',
    'dot': 'paddle.dot',
    'dpsgd': 'paddle.dpsgd',
    'dropout': 'paddle.nn.functional.dropout',
    'edit_distance': 'paddle.edit_distance',
    'eig': 'paddle.eig',
    'eigh': 'paddle.eigh',
    'eigvals': 'paddle.eigvals',
    'eigvalsh': 'paddle.eigvalsh',
    'elu': 'paddle.nn.functional.elu',
    'embedding': 'paddle.nn.functional.embedding',
    'empty': 'paddle.empty',
    'empty_like': 'paddle.empty_like',
    'equal_all': 'paddle.equal_all',
    'erf': 'paddle.erf',
    'erfinv': 'paddle.erfinv',
    'exp': 'paddle.exp',
    'expand': 'paddle.expand',
    'expand_as': 'paddle.expand_as',
    'expm1': 'paddle.expm1',
    'eye': 'paddle.eye',
    'fake_channel_wise_quantize_abs_max': 'paddle.quantization.fake_channel_wise_quantize_abs_max',
    'fake_channel_wise_quantize_dequantize_abs_max': 'paddle.quantization.fake_channel_wise_quantize_dequantize_abs_max',
    'fake_quantize_abs_max': 'paddle.quantization.fake_quantize_abs_max',
    'fake_quantize_dequantize_abs_max': 'paddle.quantization.fake_quantize_dequantize_abs_max',
    'fake_quantize_moving_average_abs_max': 'paddle.quantization.fake_quantize_moving_average_abs_max',
    'fill_diagonal': 'paddle.fill_diagonal',
    'fill_diagonal_tensor': 'paddle.fill_diagonal_tensor',
    'flash_attn_qkvpacked': 'paddle.nn.functional.flash_attn_qkvpacked',
    'flash_attn_unpadded': 'paddle.nn.functional.flash_attn_unpadded',
    'flash_attn_varlen_qkvpacked': 'paddle.nn.functional.flash_attn_varlen_qkvpacked',
    'flashmask_attention': 'paddle.nn.functional.flashmask_attention',
    'flatten': 'paddle.flatten',
    'flip': 'paddle.flip',
    'floor': 'paddle.floor',
    'floor_divide': 'paddle.floor_divide',
    'fmax': 'paddle.fmax',
    'fmin': 'paddle.fmin',
    'fold': 'paddle.nn.functional.fold',
    'fractional_max_pool2d': 'paddle.nn.functional.fractional_max_pool2d',
    'fractional_max_pool3d': 'paddle.nn.functional.fractional_max_pool3d',
    'frame': 'paddle.signal.frame',
    'full': 'paddle.full',
    'full_': 'paddle.full',
    'full_like': 'paddle.full_like',
    'gammaincc': 'paddle.gammaincc',
    'gammaln': 'paddle.gammaln',
    'gather': 'paddle.gather',
    'gather_nd': 'paddle.gather_nd',
    'gather_tree': 'paddle.nn.functional.gather_tree',
    'gelu': 'paddle.nn.functional.gelu',
    'generate_proposals': 'paddle.vision.ops.generate_proposals',
    'graph_khop_sampler': 'paddle.geometric.graph_khop_sampler',
    'graph_sample_neighbors': 'paddle.geometric.graph_sample_neighbors',
    'grid_sample': 'paddle.nn.functional.grid_sample',
    'group_norm': 'paddle.nn.functional.group_norm',
    'gumbel_softmax': 'paddle.nn.functional.gumbel_softmax',
    'hardshrink': 'paddle.nn.functional.hardshrink',
    'hardsigmoid': 'paddle.nn.functional.hardsigmoid',
    'hardtanh': 'paddle.nn.functional.hardtanh',
    'heaviside': 'paddle.heaviside',
    'histogram': 'paddle.histogram',
    'hsigmoid_loss': 'paddle.nn.functional.hsigmoid_loss',
    'huber_loss': 'paddle.nn.functional.huber_loss',
    'i0': 'paddle.i0',
    'i0e': 'paddle.i0e',
    'i1': 'paddle.i1',
    'i1e': 'paddle.i1e',
    'identity_loss': 'paddle.nn.functional.identity_loss',
    'im2sequence': 'paddle.im2sequence',
    'imag': 'paddle.imag',
    'increment': 'paddle.increment',
    'index_add': 'paddle.index_add',
    'index_put': 'paddle.index_put',
    'index_sample': 'paddle.index_sample',
    'index_select': 'paddle.index_select',
    'instance_norm': 'paddle.nn.functional.instance_norm',
    'inverse': 'paddle.inverse',
    'is_empty': 'paddle.is_empty',
    'isclose': 'paddle.isclose',
    'isfinite': 'paddle.isfinite',
    'isinf': 'paddle.isinf',
    'isnan': 'paddle.isnan',
    'kron': 'paddle.kron',
    'kthvalue': 'paddle.kthvalue',
    'label_smooth': 'paddle.nn.functional.label_smooth',
    'layer_norm': 'paddle.nn.functional.layer_norm',
    'leaky_relu': 'paddle.nn.functional.leaky_relu',
    'lerp': 'paddle.lerp',
    'lgamma': 'paddle.lgamma',
    'linspace': 'paddle.linspace',
    'llm_int8_linear': 'paddle.quantization.llm_int8_linear',
    'log': 'paddle.log',
    'log10': 'paddle.log10',
    'log1p': 'paddle.log1p',
    'log2': 'paddle.log2',
    'log_loss': 'paddle.nn.functional.log_loss',
    'log_softmax': 'paddle.nn.functional.log_softmax',
    'logcumsumexp': 'paddle.logcumsumexp',
    'logical_and': 'paddle.logical_and',
    'logical_not': 'paddle.logical_not',
    'logical_or': 'paddle.logical_or',
    'logical_xor': 'paddle.logical_xor',
    'logit': 'paddle.logit',
    'logspace': 'paddle.logspace',
    'logsumexp': 'paddle.logsumexp',
    'lp_pool2d': 'paddle.nn.functional.lp_pool2d',
    'lstsq': 'paddle.lstsq',
    'lu': 'paddle.lu',
    'lu_unpack': 'paddle.lu_unpack',
    'margin_cross_entropy': 'paddle.nn.functional.margin_cross_entropy',
    'masked_select': 'paddle.masked_select',
    'match_matrix_tensor': 'paddle.match_matrix_tensor',
    'matmul': 'paddle.matmul',
    'matrix_nms': 'paddle.vision.ops.matrix_nms',
    'matrix_power': 'paddle.matrix_power',
    'matrix_rank': 'paddle.matrix_rank',
    'max': 'paddle.max',
    'maximum': 'paddle.maximum',
    'maxout': 'paddle.nn.functional.maxout',
    'mean': 'paddle.mean',
    'merge_selected_rows': 'paddle.merge_selected_rows',
    'minimum': 'paddle.minimum',
    'mish': 'paddle.nn.functional.mish',
    'mode': 'paddle.mode',
    'multi_dot': 'paddle.multi_dot',
    'multiclass_nms3': 'paddle.vision.ops.multiclass_nms3',
    'multinomial': 'paddle.multinomial',
    'multiplex': 'paddle.multiplex',
    'mv': 'paddle.mv',
    'nanmedian': 'paddle.nanmedian',
    'nextafter': 'paddle.nextafter',
    'nll_loss': 'paddle.nn.functional.nll_loss',
    'nms': 'paddle.vision.ops.nms',
    'nonzero': 'paddle.nonzero',
    'norm': 'paddle.norm',
    'numel': 'paddle.numel',
    'one_hot': 'paddle.nn.functional.one_hot',
    'ones': 'paddle.ones',
    'ones_like': 'paddle.ones_like',
    'overlap_add': 'paddle.signal.overlap_add',
    'pad': 'paddle.nn.functional.pad',
    'pad3d': 'paddle.nn.functional.pad3d',
    'pixel_shuffle': 'paddle.nn.functional.pixel_shuffle',
    'pixel_unshuffle': 'paddle.nn.functional.pixel_unshuffle',
    'poisson': 'paddle.poisson',
    'polygamma': 'paddle.polygamma',
    'pow': 'paddle.pow',
    'prelu': 'paddle.nn.functional.prelu',
    'prior_box': 'paddle.vision.ops.prior_box',
    'prod': 'paddle.prod',
    'psroi_pool': 'paddle.vision.ops.psroi_pool',
    'put_along_axis': 'paddle.put_along_axis',
    'pyramid_hash': 'paddle.pyramid_hash',
    'qr': 'paddle.qr',
    'randint': 'paddle.randint',
    'randperm': 'paddle.randperm',
    'rank_attention': 'paddle.rank_attention',
    'read_file': 'paddle.vision.ops.read_file',
    'real': 'paddle.real',
    'reciprocal': 'paddle.reciprocal',
    'reduce_as': 'paddle.reduce_as',
    'reindex_graph': 'paddle.geometric.reindex_graph',
    'relu': 'paddle.nn.functional.relu',
    'relu6': 'paddle.nn.functional.relu6',
    'remainder': 'paddle.remainder',
    'renorm': 'paddle.renorm',
    'repeat_interleave': 'paddle.repeat_interleave',
    'reshape': 'paddle.reshape',
    'reverse': 'paddle.reverse',
    'rms_norm': 'paddle.nn.functional.rms_norm',
    'roi_align': 'paddle.vision.ops.roi_align',
    'roi_pool': 'paddle.vision.ops.roi_pool',
    'roll': 'paddle.roll',
    'round': 'paddle.round',
    'rrelu': 'paddle.nn.functional.rrelu',
    'rsqrt': 'paddle.rsqrt',
    'scale': 'paddle.scale',
    'scatter': 'paddle.scatter',
    'scatter_nd_add': 'paddle.scatter_nd_add',
    'searchsorted': 'paddle.searchsorted',
    'selu': 'paddle.nn.functional.selu',
    'send_u_recv': 'paddle.geometric.send_u_recv',
    'send_ue_recv': 'paddle.geometric.send_ue_recv',
    'send_uv': 'paddle.geometric.send_uv',
    'sequence_conv': 'paddle.sequence_conv',
    'sequence_mask': 'paddle.nn.functional.sequence_mask',
    'sequence_pool': 'paddle.sequence_pool',
    'shape': 'paddle.shape',
    'shard_index': 'paddle.shard_index',
    'sigmoid': 'paddle.sigmoid',
    'sign': 'paddle.sign',
    'silu': 'paddle.nn.functional.silu',
    'sin': 'paddle.sin',
    'sinh': 'paddle.sinh',
    'slice': 'paddle.slice',
    'slogdet': 'paddle.slogdet',
    'softmax': 'paddle.nn.functional.softmax',
    'softplus': 'paddle.nn.functional.softplus',
    'softshrink': 'paddle.nn.functional.softshrink',
    'softsign': 'paddle.nn.functional.softsign',
    'solve': 'paddle.solve',
    'sparse_attention': 'paddle.nn.functional.sparse_attention',
    'spectral_norm': 'paddle.nn.functional.spectral_norm',
    'split': 'paddle.split',
    'sqrt': 'paddle.sqrt',
    'square': 'paddle.square',
    'squeeze': 'paddle.squeeze',
    'stack': 'paddle.stack',
    'standard_gamma': 'paddle.standard_gamma',
    'stanh': 'paddle.stanh',
    'stft': 'paddle.signal.stft',
    'strided_slice': 'paddle.strided_slice',
    'sum': 'paddle.sum',
    'svd': 'paddle.svd',
    'svdvals': 'paddle.svdvals',
    'swiglu': 'paddle.nn.functional.swiglu',
    'swish': 'paddle.nn.functional.swish',
    'take_along_axis': 'paddle.take_along_axis',
    'tan': 'paddle.tan',
    'tanh': 'paddle.tanh',
    'tdm_child': 'paddle.tdm_child',
    'tdm_sampler': 'paddle.tdm_sampler',
    'temporal_shift': 'paddle.nn.functional.temporal_shift',
    'thresholded_relu': 'paddle.nn.functional.thresholded_relu',
    'topk': 'paddle.topk',
    'trace': 'paddle.trace',
    'transpose': 'paddle.transpose',
    'triangular_solve': 'paddle.triangular_solve',
    'tril': 'paddle.tril',
    'tril_indices': 'paddle.tril_indices',
    'triu': 'paddle.triu',
    'triu_indices': 'paddle.triu_indices',
    'trunc': 'paddle.trunc',
    'unbind': 'paddle.unbind',
    'unfold': 'paddle.unfold',
    'uniform': 'paddle.uniform',
    'unique': 'paddle.unique',
    'unique_consecutive': 'paddle.unique_consecutive',
    'unsqueeze': 'paddle.unsqueeze',
    'unstack': 'paddle.unstack',
    'viterbi_decode': 'paddle.text.viterbi_decode',
    'warprnnt': 'paddle.nn.functional.warprnnt',
    'weight_dequantize': 'paddle.quantization.weight_dequantize',
    'weight_only_linear': 'paddle.quantization.weight_only_linear',
    'weight_quantize': 'paddle.quantization.weight_quantize',
    'weighted_sample_neighbors': 'paddle.geometric.weighted_sample_neighbors',
    'where': 'paddle.where',
    'yolo_box': 'paddle.vision.ops.yolo_box',
    'yolo_box_head': 'paddle.vision.ops.yolo_box_head',
    'yolo_box_post': 'paddle.vision.ops.yolo_box_post',
    'yolo_loss': 'paddle.vision.ops.yolo_loss',
    'zeros': 'paddle.zeros',
    'zeros_like': 'paddle.zeros_like',
}


def abs(x):
    return _t('abs')(x=x)


def accuracy_check(x, y, fn_name, rtol=1e-5, atol=1e-8, equal_nan=False):
    return _t('accuracy_check')(x=x, y=y, fn_name=fn_name, rtol=rtol, atol=atol, equal_nan=equal_nan)


def acos(x):
    return _t('acos')(x=x)


def acosh(x):
    return _t('acosh')(x=x)


def add_position_encoding(x, alpha=1.0, beta=1.0):
    return _t('add_position_encoding')(x=x, alpha=alpha, beta=beta)


def addmm(input, x, y, beta=1.0, alpha=1.0):
    return _t('addmm')(input=input, x=x, y=y, beta=beta, alpha=alpha)


def affine_channel(x, scale, bias, data_layout='AnyLayout'):
    return _t('affine_channel')(x=x, scale=scale, bias=bias, data_layout=data_layout)


def affine_grid(input, output_shape=[], align_corners=True):
    return _t('affine_grid')(input, output_shape, align_corners)


def all(x, axis=[], keepdim=False):
    return _t('all')(x=x, axis=axis, keepdim=keepdim)


def allclose(x, y, rtol=1e-5, atol=1e-8, equal_nan=False):
    return _t('allclose')(x=x, y=y, rtol=rtol, atol=atol, equal_nan=equal_nan)


def amax(x, axis=[], keepdim=False):
    return _t('amax')(x=x, axis=axis, keepdim=keepdim)


def amin(x, axis=[], keepdim=False):
    return _t('amin')(x=x, axis=axis, keepdim=keepdim)


def angle(x):
    return _t('angle')(x=x)


def any(x, axis=[], keepdim=False):
    return _t('any')(x=x, axis=axis, keepdim=keepdim)


def apply_per_channel_scale(x, scales):
    return _t('apply_per_channel_scale')(x=x, scales=scales)


def arange(start, end, step):
    return _t('arange')(start=start, end=end, step=step)


def argmax(x, axis, keepdims=False, flatten=False, dtype='int64'):
    return _t('argmax')(x, axis, keepdims, flatten, dtype)


def argmin(x, axis, keepdims=False, flatten=False, dtype='int64'):
    return _t('argmin')(x, axis, keepdims, flatten, dtype)


def argsort(x, axis=-1, descending=False, stable=False):
    return _t('argsort')(x=x, axis=axis, descending=descending, stable=stable)


def as_complex(x):
    return _t('as_complex')(x=x)


def as_real(x):
    return _t('as_real')(x=x)


def as_strided(input, dims=[], stride=[], offset=0):
    return _t('as_strided')(input, dims, stride, offset)


def asin(x):
    return _t('asin')(x=x)


def asinh(x):
    return _t('asinh')(x=x)


def assign(x):
    return _t('assign')(x=x)


def atan(x):
    return _t('atan')(x=x)


def atan2(x, y):
    return _t('atan2')(x=x, y=y)


def atanh(x):
    return _t('atanh')(x=x)


def baddbmm(input, x, y, beta=1.0, alpha=1.0):
    return _t('baddbmm')(input=input, x=x, y=y, beta=beta, alpha=alpha)


def batch_fc(input, w, bias):
    return _t('batch_fc')(input=input, w=w, bias=bias)


def beam_search(pre_ids, pre_scores, ids, scores, level, beam_size, end_id, is_accumulated=True):
    return _t('beam_search')(pre_ids=pre_ids, pre_scores=pre_scores, ids=ids, scores=scores, level=level, beam_size=beam_size, end_id=end_id, is_accumulated=is_accumulated)


def beam_search_decode(ids, scores, beam_size, end_id):
    return _t('beam_search_decode')(ids, scores, beam_size, end_id)


def bernoulli(x):
    return _t('bernoulli')(x=x)


def bilinear(x, y, weight, bias):
    return _t('bilinear')(x, y, weight, bias)


def bincount(x, weights, minlength=0):
    return _t('bincount')(x=x, weights=weights, minlength=minlength)


def binomial(count, prob):
    return _t('binomial')(count=count, prob=prob)


def bipartite_match(dist_mat, match_type='bipartite', dist_threshold=0.5):
    return _t('bipartite_match')(dist_mat, match_type, dist_threshold)


def bitwise_and(x, y):
    return _t('bitwise_and')(x=x, y=y)


def bitwise_left_shift(x, y, is_arithmetic=True):
    return _t('bitwise_left_shift')(x, y, is_arithmetic)


def bitwise_not(x):
    return _t('bitwise_not')(x=x)


def bitwise_or(x, y):
    return _t('bitwise_or')(x=x, y=y)


def bitwise_right_shift(x, y, is_arithmetic=True):
    return _t('bitwise_right_shift')(x, y, is_arithmetic)


def bitwise_xor(x, y):
    return _t('bitwise_xor')(x=x, y=y)


def bmm(x, y):
    return _t('bmm')(x=x, y=y)


def box_clip(input, im_info):
    return _t('box_clip')(input=input, im_info=im_info)


def box_coder(prior_box, prior_box_var, target_box, code_type='encode_center_size', box_normalized=True, axis=0, variance=[]):
    return _t('box_coder')(prior_box, prior_box_var, target_box, code_type, box_normalized, axis, variance)


def broadcast_tensors(input):
    return _t('broadcast_tensors')(input)


def cast(x, dtype):
    return _t('cast')(x=x, dtype=dtype)


def ceil(x):
    return _t('ceil')(x=x)


def celu(x, alpha=1.0):
    return _t('celu')(x=x, alpha=alpha)


def channel_shuffle(x, groups, data_format='NCHW'):
    return _t('channel_shuffle')(x=x, groups=groups, data_format=data_format)


def cholesky(x, upper=False):
    return _t('cholesky')(x=x, upper=upper)


def cholesky_solve(x, y, upper=False):
    return _t('cholesky_solve')(x=x, y=y, upper=upper)


def chunk_eval(inference, label, seq_length, num_chunk_types, chunk_scheme='IOB', excluded_chunk_types=[]):
    return _t('chunk_eval')(inference=inference, label=label, seq_length=seq_length, num_chunk_types=num_chunk_types, chunk_scheme=chunk_scheme, excluded_chunk_types=excluded_chunk_types)


def class_center_sample(label, num_classes, num_samples, ring_id=0, rank=0, nranks=1, fix_seed=False, seed=0):
    return _t('class_center_sample')(label=label, num_classes=num_classes, num_samples=num_samples, ring_id=ring_id, rank=rank, nranks=nranks, fix_seed=fix_seed, seed=seed)


def clip(x, min, max):
    return _t('clip')(x=x, min=min, max=max)


def clip_by_norm(x, max_norm):
    return _t('clip_by_norm')(x=x, max_norm=max_norm)


def collect_fpn_proposals(multi_level_rois, multi_level_scores, multi_level_rois_num, post_nms_topn):
    return _t('collect_fpn_proposals')(multi_level_rois, multi_level_scores, multi_level_rois_num, post_nms_topn)


def complex(real, imag):
    return _t('complex')(real=real, imag=imag)


def concat(x, axis=0):
    return _t('concat')(x=x, axis=axis)


def conj(x):
    return _t('conj')(x=x)


def conv2d(input, filter, strides=[1, 1], paddings=[0, 0], padding_algorithm='EXPLICIT', dilations=[1, 1], groups=1, data_format='NCHW'):
    return _t('conv2d')(input, filter, strides, paddings, padding_algorithm, dilations, groups, data_format)


def conv2d_transpose(x, filter, strides=[1, 1], paddings=[0, 0], output_padding=[], output_size=[], padding_algorithm='EXPLICIT', groups=1, dilations=[1, 1], data_format='NCHW'):
    return _t('conv2d_transpose')(x, filter, strides, paddings, output_padding, output_size, padding_algorithm, groups, dilations, data_format)


def conv3d(input, filter, strides=[1, 1, 1], paddings=[0, 0, 0], padding_algorithm='EXPLICIT', groups=1, dilations=[1, 1, 1], data_format='NCDHW'):
    return _t('conv3d')(input, filter, strides, paddings, padding_algorithm, groups, dilations, data_format)


def conv3d_transpose(x, filter, strides=[1, 1, 1], paddings=[0, 0, 0], output_padding=[], output_size=[], padding_algorithm='EXPLICIT', groups=1, dilations=[1, 1, 1], data_format='NCHW'):
    return _t('conv3d_transpose')(x, filter, strides, paddings, output_padding, output_size, padding_algorithm, groups, dilations, data_format)


def copysign(x, y):
    return _t('copysign')(x=x, y=y)


def correlation(input1, input2, pad_size, kernel_size, max_displacement, stride1, stride2, corr_type_multiply=1):
    return _t('correlation')(input1=input1, input2=input2, pad_size=pad_size, kernel_size=kernel_size, max_displacement=max_displacement, stride1=stride1, stride2=stride2, corr_type_multiply=corr_type_multiply)


def cos(x):
    return _t('cos')(x=x)


def cosh(x):
    return _t('cosh')(x=x)


def crf_decoding(emission, transition, label, length):
    return _t('crf_decoding')(emission=emission, transition=transition, label=label, length=length)


def crop(x, shape=[], offsets=[]):
    return _t('crop')(x=x, shape=shape, offsets=offsets)


def cross(x, y, axis=9):
    return _t('cross')(x=x, y=y, axis=axis)


def cross_entropy(x, label, soft_label=False, ignore_index=-100):
    return _t('cross_entropy')(input=x, label=label, soft_label=soft_label, ignore_index=ignore_index)


def ctc_align(input, input_length, blank=0, merge_repeated=True, padding_value=0):
    return _t('ctc_align')(input=input, input_length=input_length, blank=blank, merge_repeated=merge_repeated, padding_value=padding_value)


def cummax(x, axis=-1, dtype='int64'):
    return _t('cummax')(x=x, axis=axis, dtype=dtype)


def cummin(x, axis=-1, dtype='int64'):
    return _t('cummin')(x=x, axis=axis, dtype=dtype)


def cumprod(x, dim, exclusive=False, reverse=False):
    return _t('cumprod')(x, dim, exclusive, reverse)


def cumsum(x, axis=-1, flatten=False, exclusive=False, reverse=False):
    return _t('cumsum')(x=x, axis=axis)


def cvm(x, cvm, use_cvm=True):
    return _t('cvm')(x, cvm, use_cvm)


def decode_jpeg(x, mode, place):
    return _t('decode_jpeg')(x, mode, place)


def deformable_conv(x, offset, filter, mask, strides, paddings, dilations, deformable_groups, groups, im2col_step):
    return _t('deformable_conv')(x, offset, filter, mask, strides, paddings, dilations, deformable_groups, groups, im2col_step)


def det(x):
    return _t('det')(x=x)


def dgc(u, v, grad, param, current_step, nranks, m=0.9, use_nesterov=True, sparsity=[], rampup_begin_step=0.0, rampup_step=0.0, regular_coeff=0.0, regular_type=0):
    return _t('dgc')(u=u, v=v, grad=grad, param=param, current_step=current_step, nranks=nranks, m=m, use_nesterov=use_nesterov, sparsity=sparsity, rampup_begin_step=rampup_begin_step, rampup_step=rampup_step, regular_coeff=regular_coeff, regular_type=regular_type)


def dgc_clip_by_norm(x, current_step, max_norm, rampup_begin_step=-1.0):
    return _t('dgc_clip_by_norm')(x=x, current_step=current_step, max_norm=max_norm, rampup_begin_step=rampup_begin_step)


def dgc_momentum(param, grad, velocity, learning_rate, master_param, current_step_tensor, nranks_tensor, mu, use_nesterov=False, regularization_method='', regularization_coeff=0.0, multi_precision=False, rescale_grad=1.0, rampup_begin_step=-1.0):
    return _t('dgc_momentum')(param=param, grad=grad, velocity=velocity, learning_rate=learning_rate, master_param=master_param, current_step_tensor=current_step_tensor, nranks_tensor=nranks_tensor, mu=mu, use_nesterov=use_nesterov, regularization_method=regularization_method, regularization_coeff=regularization_coeff, multi_precision=multi_precision, rescale_grad=rescale_grad, rampup_begin_step=rampup_begin_step)


def diag(x, offset=0, padding_value=0.0):
    return _t('diag')(x=x, offset=offset, padding_value=padding_value)


def diag_embed(input, offset=0, dim1=-2, dim2=-1):
    return _t('diag_embed')(input=input, offset=offset, dim1=dim1, dim2=dim2)


def diagonal(x, offset=0, axis1=0, axis2=1):
    return _t('diagonal')(x=x, offset=offset, axis1=axis1, axis2=axis2)


def digamma(x):
    return _t('digamma')(x=x)


def dist(x, y, p=2.0):
    return _t('dist')(x=x, y=y, p=p)


def dot(x, y):
    return _t('dot')(x=x, y=y)


def dpsgd(param, grad, learning_rate, clip=10.0, batch_size=16.0, sigma=1.0, seed=0):
    return _t('dpsgd')(param=param, grad=grad, learning_rate=learning_rate, clip=clip, batch_size=batch_size, sigma=sigma, seed=seed)


def dropout(x, seed_tensor, p, is_test, mode, seed, fix_seed):
    return _t('dropout')(x=x, p=p, training=not is_test, mode=mode)


def edit_distance(hyps, refs, hypslength, refslength, normalized=False):
    return _t('edit_distance')(hyps, refs, hypslength, refslength, normalized)


def eig(x):
    return _t('eig')(x=x)


def eigh(x, UPLO='L'):
    return _t('eigh')(x=x, UPLO=UPLO)


def eigvals(x):
    return _t('eigvals')(x=x)


def eigvalsh(x, uplo='L', is_test=False):
    return _t('eigvalsh')(x, uplo, is_test)


def elu(x, alpha=1.0):
    return _t('elu')(x=x, alpha=alpha)


def embedding(x, weight, padding_idx=-1):
    return _t('embedding')(x=x, weight=weight, padding_idx=padding_idx)


def empty(shape, dtype='float32', place='CPUPlace()'):
    return _t('empty')(shape, dtype, place)


def empty_like(x, dtype=None, place=[]):
    return _t('empty_like')(x, dtype, place)


def equal_all(x, y):
    return _t('equal_all')(x=x, y=y)


def erf(x):
    return _t('erf')(x=x)


def erfinv(x):
    return _t('erfinv')(x=x)


def exp(x):
    return _t('exp')(x=x)


def expand(x, shape=[]):
    return _t('expand')(x=x, shape=shape)


def expand_as(x, y, target_shape=[]):
    return _t('expand_as')(x, y, target_shape)


def expm1(x):
    return _t('expm1')(x=x)


def eye(num_rows, num_columns, dtype='float32', place=[]):
    return _t('eye')(num_rows, num_columns, dtype, place)


def fake_channel_wise_quantize_abs_max(x, bit_length=8, round_type=1, quant_axis=0, is_test=False):
    return _t('fake_channel_wise_quantize_abs_max')(x=x, bit_length=bit_length, quant_axis=quant_axis)


def fake_channel_wise_quantize_dequantize_abs_max(x, bit_length=8, round_type=1, quant_axis=0):
    return _t('fake_channel_wise_quantize_dequantize_abs_max')(x, bit_length, round_type, quant_axis)


def fake_quantize_abs_max(x, bit_length=8, round_type=1):
    return _t('fake_quantize_abs_max')(x, bit_length, round_type)


def fake_quantize_dequantize_abs_max(x, bit_length=8, round_type=1):
    return _t('fake_quantize_dequantize_abs_max')(x, bit_length, round_type)


def fake_quantize_moving_average_abs_max(x, in_scale, in_accum, in_state, moving_rate=0.9, bit_length=8, is_test=False, round_type=1):
    return _t('fake_quantize_moving_average_abs_max')(x=x, bit_length=bit_length)


def fill_diagonal(x, value=0, offset=0, wrap=False):
    return _t('fill_diagonal')(x=x, value=value, offset=offset, wrap=wrap)


def fill_diagonal_tensor(x, y, offset=0, dim1=0, dim2=1):
    return _t('fill_diagonal_tensor')(x=x, y=y, offset=offset, dim1=dim1, dim2=dim2)


def flash_attn_qkvpacked(qkv, fixed_seed_offset, attn_mask, dropout=0.0, causal=False, return_softmax=False, is_test=False, rng_name=''):
    return _t('flash_attn_qkvpacked')(qkv, fixed_seed_offset, attn_mask, dropout, causal, return_softmax, is_test, rng_name)


def flash_attn_unpadded(q, k, v, cu_seqlens_q, cu_seqlens_k, fixed_seed_offset, attn_mask, max_seqlen_q, max_seqlen_k, scale, dropout=0.0, causal=False, return_softmax=False, is_test=False, rng_name=''):
    return _t('flash_attn_unpadded')(q, k, v, cu_seqlens_q, cu_seqlens_k, fixed_seed_offset, attn_mask, max_seqlen_q, max_seqlen_k, scale, dropout, causal, return_softmax, is_test, rng_name)


def flash_attn_varlen_qkvpacked(qkv, cu_seqlens_q, cu_seqlens_k, fixed_seed_offset, attn_mask, max_seqlen_q, max_seqlen_k, scale, dropout=0.0, causal=False, return_softmax=False, is_test=False, rng_name='', varlen_padded=True):
    return _t('flash_attn_varlen_qkvpacked')(qkv, cu_seqlens_q, cu_seqlens_k, fixed_seed_offset, attn_mask, max_seqlen_q, max_seqlen_k, scale, dropout, causal, return_softmax, is_test, rng_name, varlen_padded)


def flashmask_attention(q, k, v, startend_row_indices, fixed_seed_offset, dropout=0.0, causal=False, return_softmax=False, is_test=False, rng_name=''):
    return _t('flashmask_attention')(q, k, v, startend_row_indices, fixed_seed_offset, dropout, causal, return_softmax, is_test, rng_name)


def flatten(x, start_axis=1, stop_axis=1):
    return _t('flatten')(x=x, start_axis=start_axis, stop_axis=stop_axis)


def flip(x, axis):
    return _t('flip')(x=x, axis=axis)


def floor(x):
    return _t('floor')(x=x)


def floor_divide(x, y, axis=-1):
    return _t('floor_divide')(x, y, axis)


def fmax(x, y):
    return _t('fmax')(x=x, y=y)


def fmin(x, y):
    return _t('fmin')(x=x, y=y)


def fold(x, output_sizes, kernel_sizes, strides, paddings, dilations):
    return _t('fold')(x=x, output_sizes=output_sizes, kernel_sizes=kernel_sizes, strides=strides, paddings=paddings, dilations=dilations)


def fractional_max_pool2d(x, output_size, kernel_size=[0, 0], random_u=0.0, return_mask=True):
    return _t('fractional_max_pool2d')(x=x, output_size=output_size, kernel_size=kernel_size, random_u=random_u, return_mask=return_mask)


def fractional_max_pool3d(x, output_size, kernel_size=[0, 0, 0], random_u=0.0, return_mask=True):
    return _t('fractional_max_pool3d')(x=x, output_size=output_size, kernel_size=kernel_size, random_u=random_u, return_mask=return_mask)


def frame(x, frame_length, hop_length, axis=-1):
    return _t('frame')(x=x, frame_length=frame_length, hop_length=hop_length, axis=axis)


def full(shape, value, dtype='float32', place='CPUPlace()'):
    return _t('full')(shape, value, dtype, place)


def full_(output, shape, value, dtype='float32', place='CPUPlace()'):
    return _t('full_')(shape=shape, fill_value=value, dtype=dtype)


def full_like(x, value, dtype=None, place=[]):
    return _t('full_like')(x=x, fill_value=value, dtype=dtype)


def gammaincc(x, y):
    return _t('gammaincc')(x=x, y=y)


def gammaln(x):
    return _t('gammaln')(x=x)


def gather(x, index, axis=0):
    return _t('gather')(x=x, index=index, axis=axis)


def gather_nd(x, index):
    return _t('gather_nd')(x=x, index=index)


def gather_tree(ids, parents):
    return _t('gather_tree')(ids=ids, parents=parents)


def gelu(x, approximate=False):
    return _t('gelu')(x=x, approximate=approximate)


def generate_proposals(scores, bbox_deltas, im_shape, anchors, variances, pre_nms_top_n, post_nms_top_n, nms_thresh, min_size, eta, pixel_offset=True):
    return _t('generate_proposals')(scores, bbox_deltas, im_shape, anchors, variances, pre_nms_top_n, post_nms_top_n, nms_thresh, min_size, eta, pixel_offset)


def graph_khop_sampler(row, colptr, x, eids, sample_sizes, return_eids):
    return _t('graph_khop_sampler')(row=row, colptr=colptr, x=x, eids=eids, sample_sizes=sample_sizes, return_eids=return_eids)


def graph_sample_neighbors(row, colptr, x, eids, perm_buffer, sample_size, return_eids, flag_perm_buffer):
    return _t('graph_sample_neighbors')(row=row, colptr=colptr, x=x, eids=eids, perm_buffer=perm_buffer, sample_size=sample_size, return_eids=return_eids, flag_perm_buffer=flag_perm_buffer)


def grid_sample(x, grid, mode='bilinear', padding_mode='zeros', align_corners=True):
    return _t('grid_sample')(x=x, grid=grid, mode=mode, padding_mode=padding_mode, align_corners=align_corners)


def group_norm(x, scale, bias, epsilon=1e-5, groups=-1, data_format='NCHW'):
    return _t('group_norm')(x, scale, bias, epsilon, groups, data_format)


def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1):
    return _t('gumbel_softmax')(x=x, temperature=temperature, hard=hard, axis=axis)


def hardshrink(x, threshold=0.5):
    return _t('hardshrink')(x=x, threshold=threshold)


def hardsigmoid(x, slope=0.2, offset=0.5):
    return _t('hardsigmoid')(x=x, slope=slope, offset=offset)


def hardtanh(x, t_min=0, t_max=24):
    return _t('hardtanh')(x, t_min, t_max)


def heaviside(x, y):
    return _t('heaviside')(x=x, y=y)


def histogram(input, weight, bins=100, min=0.0, max=0.0, density=False):
    return _t('histogram')(input=input, weight=weight, bins=bins, min=min, max=max, density=density)


def hsigmoid_loss(x, label, w, bias, path, code, num_classes, is_sparse):
    return _t('hsigmoid_loss')(x, label, w, bias, path, code, num_classes, is_sparse)


def huber_loss(input, label, delta):
    return _t('huber_loss')(input=input, label=label, delta=delta)


def i0(x):
    return _t('i0')(x=x)


def i0e(x):
    return _t('i0e')(x=x)


def i1(x):
    return _t('i1')(x=x)


def i1e(x):
    return _t('i1e')(x=x)


def identity_loss(x, reduction=1):
    return _t('identity_loss')(x=x, reduction=reduction)


def im2sequence(x, y, kernels, strides=[1, 1], paddings=[0, 0, 0, 0], out_stride=[1, 1]):
    return _t('im2sequence')(x, y, kernels, strides, paddings, out_stride)


def imag(x):
    return _t('imag')(x=x)


def increment(x, value=1.0):
    return _t('increment')(x=x, value=value)


def index_add(x, index, add_value, axis=0):
    return _t('index_add')(x, index, add_value, axis)


def index_put(x, indices, value, accumulate=False):
    return _t('index_put')(x=x, indices=indices, value=value, accumulate=accumulate)


def index_sample(x, index):
    return _t('index_sample')(x=x, index=index)


def index_select(x, index, axis=0):
    return _t('index_select')(x=x, index=index, axis=axis)


def instance_norm(x, scale, bias, epsilon=1e-5):
    return _t('instance_norm')(x, scale, bias, epsilon)


def inverse(x):
    return _t('inverse')(x=x)


def is_empty(x):
    return _t('is_empty')(x=x)


def isclose(x, y, rtol=1e-5, atol=1e-8, equal_nan=False):
    return _t('isclose')(x=x, y=y, rtol=rtol, atol=atol, equal_nan=equal_nan)


def isfinite(x):
    return _t('isfinite')(x=x)


def isinf(x):
    return _t('isinf')(x=x)


def isnan(x):
    return _t('isnan')(x=x)


def kron(x, y):
    return _t('kron')(x=x, y=y)


def kthvalue(x, k=1, axis=-1, keepdim=False):
    return _t('kthvalue')(x=x, k=k, axis=axis, keepdim=keepdim)


def label_smooth(label, prior_dist, epsilon=0.0):
    return _t('label_smooth')(label=label, prior_dist=prior_dist, epsilon=epsilon)


def layer_norm(x, scale, bias, epsilon=1e-5, begin_norm_axis=1):
    return _t('layer_norm')(x, scale, bias, epsilon, begin_norm_axis)


def leaky_relu(x, negative_slope=0.02):
    return _t('leaky_relu')(x=x, negative_slope=negative_slope)


def lerp(x, y, weight):
    return _t('lerp')(x=x, y=y, weight=weight)


def lgamma(x):
    return _t('lgamma')(x=x)


def linspace(start, stop, number, dtype, place):
    return _t('linspace')(start, stop, number, dtype, place)


def llm_int8_linear(x, weight, bias, weight_scale, threshold=6.0):
    return _t('llm_int8_linear')(x=x, weight=weight, bias=bias, weight_scale=weight_scale, threshold=threshold)


def log(x):
    return _t('log')(x=x)


def log10(x):
    return _t('log10')(x=x)


def log1p(x):
    return _t('log1p')(x=x)


def log2(x):
    return _t('log2')(x=x)


def log_loss(input, label, epsilon):
    return _t('log_loss')(input=input, label=label, epsilon=epsilon)


def log_softmax(x, axis=-1):
    return _t('log_softmax')(x=x, axis=axis)


def logcumsumexp(x, axis=-1, flatten=False, exclusive=False, reverse=False):
    return _t('logcumsumexp')(x=x, axis=axis)


def logical_and(x, y):
    return _t('logical_and')(x=x, y=y)


def logical_not(x):
    return _t('logical_not')(x=x)


def logical_or(x, y):
    return _t('logical_or')(x=x, y=y)


def logical_xor(x, y):
    return _t('logical_xor')(x=x, y=y)


def logit(x, eps=1e-6):
    return _t('logit')(x, eps)


def logspace(start, stop, num, base, dtype, place=[]):
    return _t('logspace')(start, stop, num, base, dtype, place)


def logsumexp(x, axis=[0], keepdim=False, reduce_all=False):
    return _t('logsumexp')(x, axis, keepdim, reduce_all)


def lp_pool2d(x, kernel_size, strides=[1,1], paddings=[0,0], ceil_mode=False, exclusive=True, data_format='NCHW', pooling_type='', global_pooling=False, adaptive=False, padding_algorithm='EXPLICIT', norm_type=0.0):
    return _t('lp_pool2d')(x=x, kernel_size=kernel_size, ceil_mode=ceil_mode, data_format=data_format, norm_type=norm_type)


def lstsq(x, y, rcond=0.0, driver='gels'):
    return _t('lstsq')(x=x, y=y, rcond=rcond, driver=driver)


def lu(x, pivot=True):
    return _t('lu')(x=x, pivot=pivot)


def lu_unpack(x, y, unpack_ludata=True, unpack_pivots=True):
    return _t('lu_unpack')(x=x, y=y, unpack_ludata=unpack_ludata, unpack_pivots=unpack_pivots)


def margin_cross_entropy(logits, label, return_softmax=False, ring_id=0, rank=0, nranks=1, margin1=1.0, margin2=0.5, margin3=0.0, scale=64.0):
    return _t('margin_cross_entropy')(logits, label, return_softmax, ring_id, rank, nranks, margin1, margin2, margin3, scale)


def masked_select(x, mask):
    return _t('masked_select')(x=x, mask=mask)


def match_matrix_tensor(x, y, w, dim_t=1):
    return _t('match_matrix_tensor')(x=x, y=y, w=w, dim_t=dim_t)


def matmul(x, y, transpose_x=False, transpose_y=False):
    return _t('matmul')(x=x, y=y, transpose_x=transpose_x, transpose_y=transpose_y)


def matrix_nms(bboxes, scores, score_threshold, nms_top_k, keep_top_k, post_threshold=0., use_gaussian=False, gaussian_sigma=2., background_label=0, normalized=True):
    return _t('matrix_nms')(bboxes=bboxes, scores=scores, score_threshold=score_threshold, nms_top_k=nms_top_k, keep_top_k=keep_top_k, post_threshold=post_threshold, use_gaussian=use_gaussian, gaussian_sigma=gaussian_sigma, background_label=background_label, normalized=normalized)


def matrix_power(x, n):
    return _t('matrix_power')(x=x, n=n)


def matrix_rank(x, tol, use_default_tol=True, hermitian=False):
    return _t('matrix_rank')(x, tol, use_default_tol, hermitian)


def max(x, axis=[], keepdim=False):
    return _t('max')(x=x, axis=axis, keepdim=keepdim)


def maximum(x, y, axis=-1):
    return _t('maximum')(x, y, axis)


def maxout(x, groups, axis=1):
    return _t('maxout')(x=x, groups=groups, axis=axis)


def mean(x, axis=[], keepdim=False):
    return _t('mean')(x=x, axis=axis, keepdim=keepdim)


def merge_selected_rows(x):
    return _t('merge_selected_rows')(x=x)


def minimum(x, y, axis=-1):
    return _t('minimum')(x, y, axis)


def mish(x, lambda_):
    return _t('mish')(x, lambda_)


def mode(x, axis=-1, keepdim=False):
    return _t('mode')(x=x, axis=axis, keepdim=keepdim)


def multi_dot(x):
    return _t('multi_dot')(x=x)


def multiclass_nms3(bboxes, scores, rois_num, score_threshold, nms_top_k, keep_top_k, nms_threshold=0.3, normalized=True, nms_eta=1.0, background_label=0):
    return _t('multiclass_nms3')(bboxes=bboxes, scores=scores, rois_num=rois_num, score_threshold=score_threshold, nms_top_k=nms_top_k, keep_top_k=keep_top_k, nms_threshold=nms_threshold, normalized=normalized, nms_eta=nms_eta, background_label=background_label)


def multinomial(x, num_samples=1, replacement=False):
    return _t('multinomial')(x=x, num_samples=num_samples, replacement=replacement)


def multiplex(inputs, index):
    return _t('multiplex')(inputs=inputs, index=index)


def mv(x, vec):
    return _t('mv')(x=x, vec=vec)


def nanmedian(x, axis=[], keepdim=True, mode='avg'):
    return _t('nanmedian')(x, axis, keepdim, mode)


def nextafter(x, y):
    return _t('nextafter')(x=x, y=y)


def nll_loss(input, label, weight, ignore_index=-100, reduction='mean'):
    return _t('nll_loss')(input=input, label=label, weight=weight, ignore_index=ignore_index, reduction=reduction)


def nms(x, threshold=1.0):
    return _t('nms')(x, threshold)


def nonzero(condition):
    return _t('nonzero')(condition)


def norm(x, axis, epsilon, is_test):
    return _t('norm')(x, axis, epsilon, is_test)


def numel(x):
    return _t('numel')(x=x)


def one_hot(x, num_classes):
    return _t('one_hot')(x=x, num_classes=num_classes)


def ones(shape, dtype='float32', place='CPUPlace()'):
    return _t('ones')(shape, dtype, place)


def ones_like(x, dtype=None, place=[]):
    return _t('ones_like')(x, dtype, place)


def overlap_add(x, hop_length, axis=-1):
    return _t('overlap_add')(x=x, hop_length=hop_length, axis=axis)


def pad(x, paddings, pad_value):
    return _t('pad')(x, paddings, pad_value)


def pad3d(x, paddings, mode='constant', pad_value=0.0, data_format='NCDHW'):
    return _t('pad3d')(x, paddings, mode, pad_value, data_format)


def pixel_shuffle(x, upscale_factor=1, data_format='NCHW'):
    return _t('pixel_shuffle')(x=x, upscale_factor=upscale_factor, data_format=data_format)


def pixel_unshuffle(x, downscale_factor=1, data_format='NCHW'):
    return _t('pixel_unshuffle')(x=x, downscale_factor=downscale_factor, data_format=data_format)


def poisson(x):
    return _t('poisson')(x=x)


def polygamma(x, n):
    return _t('polygamma')(x=x, n=n)


def pow(x, y=1.0):
    return _t('pow')(x=x, y=y)


def prelu(x, alpha, data_format='NCHW', mode='all'):
    return _t('prelu')(x, alpha, data_format, mode)


def prior_box(input, image, min_sizes, max_sizes=[], aspect_ratios=[], variances=[], flip=True, clip=True, step_w=0.0, step_h=0.0, offset=0.5, min_max_aspect_ratios_order=False):
    return _t('prior_box')(input=input, image=image, min_sizes=min_sizes, max_sizes=max_sizes, aspect_ratios=aspect_ratios, flip=flip, clip=clip, offset=offset, min_max_aspect_ratios_order=min_max_aspect_ratios_order)


def prod(x, axis, keepdim, reduce_all):
    return _t('prod')(x, axis, keepdim, reduce_all)


def psroi_pool(x, boxes, boxes_num, pooled_height=1, pooled_width=1, output_channels=1, spatial_scale=1.0):
    return _t('psroi_pool')(x=x, boxes=boxes, boxes_num=boxes_num, pooled_height=pooled_height, pooled_width=pooled_width, output_channels=output_channels, spatial_scale=spatial_scale)


def put_along_axis(arr, indices, values, axis, reduce='assign', include_self=True):
    return _t('put_along_axis')(arr=arr, indices=indices, values=values, axis=axis, reduce=reduce, include_self=include_self)


def pyramid_hash(x, w, white_list, black_list, num_emb=0, space_len=0, pyramid_layer=2, rand_len=0, drop_out_percent=0, is_training=0, use_filter=True, white_list_len=0, black_list_len=0, seed=0, lr=0.0, distribute_update_vars=''):
    return _t('pyramid_hash')(x=x, w=w, white_list=white_list, black_list=black_list, num_emb=num_emb, space_len=space_len, pyramid_layer=pyramid_layer, rand_len=rand_len, drop_out_percent=drop_out_percent, is_training=is_training, use_filter=use_filter, white_list_len=white_list_len, black_list_len=black_list_len, seed=seed, lr=lr, distribute_update_vars=distribute_update_vars)


def qr(x, mode='reduced'):
    return _t('qr')(x=x, mode=mode)


def randint(low, high, shape, dtype='int64', place=[]):
    return _t('randint')(low, high, shape, dtype, place)


def randperm(n, dtype, place=[]):
    return _t('randperm')(n, dtype, place)


def rank_attention(x, rank_offset, rank_param, max_rank=3, max_size=0):
    return _t('rank_attention')(x=x, rank_offset=rank_offset, rank_param=rank_param, max_rank=max_rank, max_size=max_size)


def read_file(filename='', dtype='uint8', place='CPUPlace()'):
    return _t('read_file')(filename=filename, dtype=dtype, place=place)


def real(x):
    return _t('real')(x=x)


def reciprocal(x):
    return _t('reciprocal')(x=x)


def reduce_as(x, target):
    return _t('reduce_as')(x=x, target=target)


def reindex_graph(x, neighbors, count, hashtable_value, hashtable_index):
    return _t('reindex_graph')(x, neighbors, count, hashtable_value, hashtable_index)


def relu(x):
    return _t('relu')(x=x)


def relu6(x):
    return _t('relu6')(x=x)


def remainder(x, y, axis=-1):
    return _t('remainder')(x, y, axis)


def renorm(x, p, axis, max_norm):
    return _t('renorm')(x=x, p=p, axis=axis, max_norm=max_norm)


def repeat_interleave(x, repeats, axis):
    return _t('repeat_interleave')(x=x, repeats=repeats, axis=axis)


def reshape(x, shape):
    return _t('reshape')(x=x, shape=shape)


def reverse(x, axis):
    return _t('reverse')(x=x, axis=axis)


def rms_norm(x, bias, residual, norm_weight, norm_bias, epsilon, begin_norm_axis, quant_scale, quant_round_type, quant_max_bound, quant_min_bound):
    return _t('rms_norm')(x=x, epsilon=epsilon)


def roi_align(x, boxes, boxes_num, pooled_height=1, pooled_width=1, spatial_scale=1.0, sampling_ratio=-1, aligned=False):
    return _t('roi_align')(x, boxes, boxes_num, pooled_height, pooled_width, spatial_scale, sampling_ratio, aligned)


def roi_pool(x, boxes, boxes_num, pooled_height=1, pooled_width=1, spatial_scale=1.0):
    return _t('roi_pool')(x, boxes, boxes_num, pooled_height, pooled_width, spatial_scale)


def roll(x, shifts=[], axis=[]):
    return _t('roll')(x=x, shifts=shifts, axis=axis)


def round(x, decimals=0):
    return _t('round')(x, decimals)


def rrelu(x, lower='1.0f/8', upper='1.0f/3', is_test=False):
    return _t('rrelu')(x, lower, upper, is_test)


def rsqrt(x):
    return _t('rsqrt')(x=x)


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True):
    return _t('scale')(x=x, scale=scale, bias=bias, bias_after_scale=bias_after_scale)


def scatter(x, index, updates, overwrite=True):
    return _t('scatter')(x=x, index=index, updates=updates, overwrite=overwrite)


def scatter_nd_add(x, index, updates):
    return _t('scatter_nd_add')(x=x, index=index, updates=updates)


def searchsorted(sorted_sequence, values, out_int32=False, right=False):
    return _t('searchsorted')(sorted_sequence=sorted_sequence, values=values, out_int32=out_int32, right=right)


def selu(x, scale=1.0507009873554804934193349852946, alpha=1.6732632423543772848170429916717):
    return _t('selu')(x=x, scale=scale, alpha=alpha)


def send_u_recv(x, src_index, dst_index, reduce_op='SUM', out_size=[0]):
    return _t('send_u_recv')(x=x, src_index=src_index, dst_index=dst_index, reduce_op=reduce_op, out_size=out_size)


def send_ue_recv(x, y, src_index, dst_index, message_op='ADD', reduce_op='SUM', out_size=[0]):
    return _t('send_ue_recv')(x=x, y=y, src_index=src_index, dst_index=dst_index, message_op=message_op, reduce_op=reduce_op, out_size=out_size)


def send_uv(x, y, src_index, dst_index, message_op='ADD'):
    return _t('send_uv')(x=x, y=y, src_index=src_index, dst_index=dst_index, message_op=message_op)


def sequence_conv(x, padding_data, filter, context_length, padding_trainable=False, context_start=0, context_stride=1):
    return _t('sequence_conv')(x=x, padding_data=padding_data, filter=filter, context_length=context_length, padding_trainable=padding_trainable, context_start=context_start, context_stride=context_stride)


def sequence_mask(x, max_len, out_dtype):
    return _t('sequence_mask')(x, max_len, out_dtype)


def sequence_pool(x, is_test=False, pooltype='AVERAGE', pad_value=0.0):
    return _t('sequence_pool')(x=x, is_test=is_test, pooltype=pooltype, pad_value=pad_value)


def shape(input):
    return _t('shape')(input=input)


def shard_index(input, index_num, nshards, shard_id, ignore_value=-1):
    return _t('shard_index')(input=input, index_num=index_num, nshards=nshards, shard_id=shard_id, ignore_value=ignore_value)


def sigmoid(x):
    return _t('sigmoid')(x=x)


def sign(x):
    return _t('sign')(x=x)


def silu(x):
    return _t('silu')(x=x)


def sin(x):
    return _t('sin')(x=x)


def sinh(x):
    return _t('sinh')(x=x)


def slice(input, axes, starts, ends, infer_flags, decrease_axis):
    return _t('slice')(input=input, axes=axes, starts=starts, ends=ends)


def slogdet(x):
    return _t('slogdet')(x=x)


def softmax(x, axis=-1):
    return _t('softmax')(x=x, axis=axis)


def softplus(x, beta=1.0, threshold=20.0):
    return _t('softplus')(x=x, beta=beta, threshold=threshold)


def softshrink(x, threshold=0.5):
    return _t('softshrink')(x=x, threshold=threshold)


def softsign(x):
    return _t('softsign')(x=x)


def solve(x, y):
    return _t('solve')(x=x, y=y)


def sparse_attention(q, k, v, offset, columns, key_padding_mask, attn_mask):
    return _t('sparse_attention')(q, k, v, offset, columns, key_padding_mask, attn_mask)


def spectral_norm(weight, u, v, dim=0, power_iters=1, eps=1e-12):
    return _t('spectral_norm')(weight, u, v, dim, power_iters, eps)


def split(x, sections, axis):
    return _t('split')(x, sections, axis)


def sqrt(x):
    return _t('sqrt')(x=x)


def square(x):
    return _t('square')(x=x)


def squeeze(x, axis=[]):
    return _t('squeeze')(x=x, axis=axis)


def stack(x, axis=0):
    return _t('stack')(x=x, axis=axis)


def standard_gamma(x):
    return _t('standard_gamma')(x=x)


def stanh(x, scale_a=0.67, scale_b=1.7159):
    return _t('stanh')(x=x, scale_a=scale_a, scale_b=scale_b)


def stft(x, window, n_fft, hop_length, normalized, onesided):
    return _t('stft')(x=x, window=window, n_fft=n_fft, hop_length=hop_length, normalized=normalized, onesided=onesided)


def strided_slice(x, axes, starts, ends, strides):
    return _t('strided_slice')(x=x, axes=axes, starts=starts, ends=ends, strides=strides)


def sum(x, axis=[], dtype=None, keepdim=False):
    return _t('sum')(x=x, axis=axis, dtype=dtype, keepdim=keepdim)


def svd(x, full_matrices=False):
    return _t('svd')(x=x, full_matrices=full_matrices)


def svdvals(x):
    return _t('svdvals')(x=x)


def swiglu(x, y):
    return _t('swiglu')(x=x, y=y)


def swish(x):
    return _t('swish')(x=x)


def take_along_axis(arr, indices, axis):
    return _t('take_along_axis')(arr=arr, indices=indices, axis=axis)


def tan(x):
    return _t('tan')(x=x)


def tanh(x):
    return _t('tanh')(x=x)


def tdm_child(x, tree_info, child_nums, dtype='int32'):
    return _t('tdm_child')(x=x, tree_info=tree_info, child_nums=child_nums, dtype=dtype)


def tdm_sampler(x, travel, layer, output_positive=True, neg_samples_num_list=[], layer_offset=[], seed=0, dtype=2):
    return _t('tdm_sampler')(x=x, travel=travel, layer=layer, output_positive=output_positive, neg_samples_num_list=neg_samples_num_list, layer_offset=layer_offset, seed=seed, dtype=dtype)


def temporal_shift(x, seg_num, shift_ratio=0.25, data_format='NCHW'):
    return _t('temporal_shift')(x=x, seg_num=seg_num, shift_ratio=shift_ratio, data_format=data_format)


def thresholded_relu(x, threshold=1.0, value=0.0):
    return _t('thresholded_relu')(x=x, threshold=threshold, value=value)


def topk(x, k=1, axis=-1, largest=True, sorted=True):
    return _t('topk')(x=x, k=k, axis=axis, largest=largest, sorted=sorted)


def trace(x, offset=0, axis1=0, axis2=1):
    return _t('trace')(x=x, offset=offset, axis1=axis1, axis2=axis2)


def transpose(x, perm):
    return _t('transpose')(x=x, perm=perm)


def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False):
    return _t('triangular_solve')(x=x, y=y, upper=upper, transpose=transpose, unitriangular=unitriangular)


def tril(x, diagonal):
    return _t('tril')(x=x, diagonal=diagonal)


def tril_indices(rows, cols, offset, dtype, place=[]):
    return _t('tril_indices')(rows, cols, offset, dtype, place)


def triu(x, diagonal):
    return _t('triu')(x=x, diagonal=diagonal)


def triu_indices(row, col, offset, dtype, place=[]):
    return _t('triu_indices')(row, col, offset, dtype, place)


def trunc(input):
    return _t('trunc')(input)


def unbind(input, axis=0):
    return _t('unbind')(input, axis)


def unfold(x, kernel_sizes, strides, paddings, dilations):
    return _t('unfold')(x, kernel_sizes, strides, paddings, dilations)


def uniform(shape, dtype, min, max, seed, place=[]):
    return _t('uniform')(shape, dtype, min, max, seed, place)


def unique(x, return_index=False, return_inverse=False, return_counts=False, axis=[], dtype='int64', is_sorted=False):
    return _t('unique')(x, return_index, return_inverse, return_counts, axis, dtype, is_sorted)


def unique_consecutive(x, return_inverse=False, return_counts=False, axis=[], dtype='float32'):
    return _t('unique_consecutive')(x=x, return_inverse=return_inverse, return_counts=return_counts, axis=axis, dtype=dtype)


def unsqueeze(x, axis=[]):
    return _t('unsqueeze')(x=x, axis=axis)


def unstack(x, axis=0, num=0):
    return _t('unstack')(x=x, axis=axis, num=num)


def viterbi_decode(potentials, transition_params, lengths, include_bos_eos_tag=True):
    return _t('viterbi_decode')(potentials=potentials, transition_params=transition_params, lengths=lengths, include_bos_eos_tag=include_bos_eos_tag)


def warprnnt(input, label, input_lengths, label_lengths, blank=0, fastemit_lambda=0.0):
    return _t('warprnnt')(input=input, label=label, input_lengths=input_lengths, label_lengths=label_lengths, blank=blank, fastemit_lambda=fastemit_lambda)


def weight_dequantize(x, scale, algo='weight_only_int8', out_dtype='float16', group_size=-1):
    return _t('weight_dequantize')(x=x, scale=scale, algo=algo, out_dtype=out_dtype, group_size=group_size)


def weight_only_linear(x, weight, bias, weight_scale, weight_dtype, arch=80, group_size=-1):
    return _t('weight_only_linear')(x=x, weight=weight, bias=bias, weight_scale=weight_scale, weight_dtype=weight_dtype, arch=arch, group_size=group_size)


def weight_quantize(x, algo='weight_only_int8', arch=80, group_size=-1):
    return _t('weight_quantize')(x=x, algo=algo, arch=arch, group_size=group_size)


def weighted_sample_neighbors(row, colptr, edge_weight, input_nodes, eids, sample_size, return_eids):
    return _t('weighted_sample_neighbors')(row=row, colptr=colptr, edge_weight=edge_weight, input_nodes=input_nodes, eids=eids, sample_size=sample_size, return_eids=return_eids)


def where(condition, x, y):
    return _t('where')(condition=condition, x=x, y=y)


def yolo_box(x, img_size, anchors=[], class_num=1, conf_thresh=0.01, downsample_ratio=32, clip_bbox=True, scale_x_y=1.0, iou_aware=False, iou_aware_factor=0.5):
    return _t('yolo_box')(x=x, img_size=img_size, anchors=anchors, class_num=class_num, conf_thresh=conf_thresh, downsample_ratio=downsample_ratio, clip_bbox=clip_bbox, scale_x_y=scale_x_y, iou_aware=iou_aware, iou_aware_factor=iou_aware_factor)


def yolo_box_head(x, anchors, class_num):
    return _t('yolo_box_head')(x=x, anchors=anchors, class_num=class_num)


def yolo_box_post(boxes0, boxes1, boxes2, image_shape, image_scale, anchors0, anchors1, anchors2, class_num, conf_thresh, downsample_ratio0, downsample_ratio1, downsample_ratio2, clip_bbox, scale_x_y, nms_threshold):
    return _t('yolo_box_post')(boxes0=boxes0, boxes1=boxes1, boxes2=boxes2, image_shape=image_shape, image_scale=image_scale, anchors0=anchors0, anchors1=anchors1, anchors2=anchors2, class_num=class_num, conf_thresh=conf_thresh, downsample_ratio0=downsample_ratio0, downsample_ratio1=downsample_ratio1, downsample_ratio2=downsample_ratio2, clip_bbox=clip_bbox, scale_x_y=scale_x_y, nms_threshold=nms_threshold)


def yolo_loss(x, gt_box, gt_label, gt_score, anchors=[], anchor_mask=[], class_num=1, ignore_thresh=0.7, downsample_ratio=32, use_label_smooth=True, scale_x_y=1.0):
    return _t('yolo_loss')(x=x, gt_box=gt_box, gt_label=gt_label, gt_score=gt_score, anchors=anchors, anchor_mask=anchor_mask, class_num=class_num, ignore_thresh=ignore_thresh, downsample_ratio=downsample_ratio, use_label_smooth=use_label_smooth, scale_x_y=scale_x_y)


def zeros(shape, dtype='float32', place='CPUPlace()'):
    return _t('zeros')(shape, dtype, place)


def zeros_like(x, dtype=None, place=[]):
    return _t('zeros_like')(x, dtype, place)


__all__ = [
    'abs',
    'accuracy_check',
    'acos',
    'acosh',
    'add_position_encoding',
    'addmm',
    'affine_channel',
    'affine_grid',
    'all',
    'allclose',
    'amax',
    'amin',
    'angle',
    'any',
    'apply_per_channel_scale',
    'arange',
    'argmax',
    'argmin',
    'argsort',
    'as_complex',
    'as_real',
    'as_strided',
    'asin',
    'asinh',
    'assign',
    'atan',
    'atan2',
    'atanh',
    'baddbmm',
    'batch_fc',
    'beam_search',
    'beam_search_decode',
    'bernoulli',
    'bilinear',
    'bincount',
    'binomial',
    'bipartite_match',
    'bitwise_and',
    'bitwise_left_shift',
    'bitwise_not',
    'bitwise_or',
    'bitwise_right_shift',
    'bitwise_xor',
    'bmm',
    'box_clip',
    'box_coder',
    'broadcast_tensors',
    'cast',
    'ceil',
    'celu',
    'channel_shuffle',
    'cholesky',
    'cholesky_solve',
    'chunk_eval',
    'class_center_sample',
    'clip',
    'clip_by_norm',
    'collect_fpn_proposals',
    'complex',
    'concat',
    'conj',
    'conv2d',
    'conv2d_transpose',
    'conv3d',
    'conv3d_transpose',
    'copysign',
    'correlation',
    'cos',
    'cosh',
    'crf_decoding',
    'crop',
    'cross',
    'cross_entropy',
    'ctc_align',
    'cummax',
    'cummin',
    'cumprod',
    'cumsum',
    'cvm',
    'decode_jpeg',
    'deformable_conv',
    'det',
    'dgc',
    'dgc_clip_by_norm',
    'dgc_momentum',
    'diag',
    'diag_embed',
    'diagonal',
    'digamma',
    'dist',
    'dot',
    'dpsgd',
    'dropout',
    'edit_distance',
    'eig',
    'eigh',
    'eigvals',
    'eigvalsh',
    'elu',
    'embedding',
    'empty',
    'empty_like',
    'equal_all',
    'erf',
    'erfinv',
    'exp',
    'expand',
    'expand_as',
    'expm1',
    'eye',
    'fake_channel_wise_quantize_abs_max',
    'fake_channel_wise_quantize_dequantize_abs_max',
    'fake_quantize_abs_max',
    'fake_quantize_dequantize_abs_max',
    'fake_quantize_moving_average_abs_max',
    'fill_diagonal',
    'fill_diagonal_tensor',
    'flash_attn_qkvpacked',
    'flash_attn_unpadded',
    'flash_attn_varlen_qkvpacked',
    'flashmask_attention',
    'flatten',
    'flip',
    'floor',
    'floor_divide',
    'fmax',
    'fmin',
    'fold',
    'fractional_max_pool2d',
    'fractional_max_pool3d',
    'frame',
    'full',
    'full_',
    'full_like',
    'gammaincc',
    'gammaln',
    'gather',
    'gather_nd',
    'gather_tree',
    'gelu',
    'generate_proposals',
    'graph_khop_sampler',
    'graph_sample_neighbors',
    'grid_sample',
    'group_norm',
    'gumbel_softmax',
    'hardshrink',
    'hardsigmoid',
    'hardtanh',
    'heaviside',
    'histogram',
    'hsigmoid_loss',
    'huber_loss',
    'i0',
    'i0e',
    'i1',
    'i1e',
    'identity_loss',
    'im2sequence',
    'imag',
    'increment',
    'index_add',
    'index_put',
    'index_sample',
    'index_select',
    'instance_norm',
    'inverse',
    'is_empty',
    'isclose',
    'isfinite',
    'isinf',
    'isnan',
    'kron',
    'kthvalue',
    'label_smooth',
    'layer_norm',
    'leaky_relu',
    'lerp',
    'lgamma',
    'linspace',
    'llm_int8_linear',
    'log',
    'log10',
    'log1p',
    'log2',
    'log_loss',
    'log_softmax',
    'logcumsumexp',
    'logical_and',
    'logical_not',
    'logical_or',
    'logical_xor',
    'logit',
    'logspace',
    'logsumexp',
    'lp_pool2d',
    'lstsq',
    'lu',
    'lu_unpack',
    'margin_cross_entropy',
    'masked_select',
    'match_matrix_tensor',
    'matmul',
    'matrix_nms',
    'matrix_power',
    'matrix_rank',
    'max',
    'maximum',
    'maxout',
    'mean',
    'merge_selected_rows',
    'minimum',
    'mish',
    'mode',
    'multi_dot',
    'multiclass_nms3',
    'multinomial',
    'multiplex',
    'mv',
    'nanmedian',
    'nextafter',
    'nll_loss',
    'nms',
    'nonzero',
    'norm',
    'numel',
    'one_hot',
    'ones',
    'ones_like',
    'overlap_add',
    'pad',
    'pad3d',
    'pixel_shuffle',
    'pixel_unshuffle',
    'poisson',
    'polygamma',
    'pow',
    'prelu',
    'prior_box',
    'prod',
    'psroi_pool',
    'put_along_axis',
    'pyramid_hash',
    'qr',
    'randint',
    'randperm',
    'rank_attention',
    'read_file',
    'real',
    'reciprocal',
    'reduce_as',
    'reindex_graph',
    'relu',
    'relu6',
    'remainder',
    'renorm',
    'repeat_interleave',
    'reshape',
    'reverse',
    'rms_norm',
    'roi_align',
    'roi_pool',
    'roll',
    'round',
    'rrelu',
    'rsqrt',
    'scale',
    'scatter',
    'scatter_nd_add',
    'searchsorted',
    'selu',
    'send_u_recv',
    'send_ue_recv',
    'send_uv',
    'sequence_conv',
    'sequence_mask',
    'sequence_pool',
    'shape',
    'shard_index',
    'sigmoid',
    'sign',
    'silu',
    'sin',
    'sinh',
    'slice',
    'slogdet',
    'softmax',
    'softplus',
    'softshrink',
    'softsign',
    'solve',
    'sparse_attention',
    'spectral_norm',
    'split',
    'sqrt',
    'square',
    'squeeze',
    'stack',
    'standard_gamma',
    'stanh',
    'stft',
    'strided_slice',
    'sum',
    'svd',
    'svdvals',
    'swiglu',
    'swish',
    'take_along_axis',
    'tan',
    'tanh',
    'tdm_child',
    'tdm_sampler',
    'temporal_shift',
    'thresholded_relu',
    'topk',
    'trace',
    'transpose',
    'triangular_solve',
    'tril',
    'tril_indices',
    'triu',
    'triu_indices',
    'trunc',
    'unbind',
    'unfold',
    'uniform',
    'unique',
    'unique_consecutive',
    'unsqueeze',
    'unstack',
    'viterbi_decode',
    'warprnnt',
    'weight_dequantize',
    'weight_only_linear',
    'weight_quantize',
    'weighted_sample_neighbors',
    'where',
    'yolo_box',
    'yolo_box_head',
    'yolo_box_post',
    'yolo_loss',
    'zeros',
    'zeros_like',
]
