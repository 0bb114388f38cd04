"""paddle.incubate of the port (`paddle_tpu/incubate/__init__.py`): the
fused layers and functions of `incubate.nn`, and the graph ops over
`geometric` (the segment reductions, `graph_send_recv`, `graph_reindex`,
`graph_sample_neighbors`, `graph_khop_sampler`) with `identity_loss` and
`inference`.

`graph_khop_sampler` takes the reference's `sorted_eids` and passes it to
`geometric.khop_sampler` as its `eids` (the JAX package passes a keyword
`khop_sampler` has no parameter for, and raises TypeError). The rest of
the JAX module (`softmax_mask_fuse*`, LookAhead, ModelAverage, the MoE
layers of `incubate.distributed`) is ported with ROADMAP A10g part 2: its
names raise AttributeError saying so.
"""

from paddle_tpu_torch.incubate import nn  # noqa: F401
from paddle_tpu_torch.geometric import (  # noqa: F401
    segment_max, segment_mean, segment_min, segment_sum,
)
from paddle_tpu_torch.nn.functional.loss import identity_loss  # noqa: F401
from paddle_tpu_torch import inference  # noqa: F401

_PART_2 = ("softmax_mask_fuse", "softmax_mask_fuse_upper_triangle",
           "LookAhead", "ModelAverage", "distributed")


def __getattr__(name):
    if name in _PART_2:
        raise AttributeError(
            f"paddle.incubate.{name} is ported with ROADMAP A10g part 2 (the "
            "fused softmax, LookAhead, ModelAverage and the MoE layers)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def graph_send_recv(x, src_index, dst_index, pool_type="sum",
                    out_size=None, name=None):
    """reference incubate graph_send_recv: the pre-geometric spelling of
    geometric.send_u_recv."""
    from paddle_tpu_torch.geometric import send_u_recv

    return send_u_recv(x, src_index, dst_index, reduce_op=pool_type,
                       out_size=out_size)


def graph_reindex(x, neighbors, count, value_buffer=None,
                  index_buffer=None, flag_buffer_hashtable=False,
                  name=None):
    from paddle_tpu_torch.geometric import reindex_graph

    return reindex_graph(x, neighbors, count, value_buffer, index_buffer)


def graph_sample_neighbors(row, colptr, input_nodes, eids=None,
                           perm_buffer=None, sample_size=-1,
                           return_eids=False, flag_perm_buffer=False,
                           name=None):
    from paddle_tpu_torch.geometric import sample_neighbors

    return sample_neighbors(row, colptr, input_nodes, sample_size=sample_size,
                            eids=eids, return_eids=return_eids,
                            perm_buffer=perm_buffer)


def graph_khop_sampler(row, colptr, input_nodes, sample_sizes,
                       sorted_eids=None, return_eids=False, name=None):
    """reference incubate graph_khop_sampler: `sorted_eids` are the edge
    ids aligned with `row`, `geometric.khop_sampler`'s `eids`."""
    from paddle_tpu_torch.geometric import khop_sampler

    return khop_sampler(row, colptr, input_nodes, eids=sorted_eids,
                        sample_sizes=sample_sizes, return_eids=return_eids)
