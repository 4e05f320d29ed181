"""Front-compaction of live samples — port of ``xrnerf_tpu/ops/compaction.py``.

``keep_first_k(live, k)`` returns, per row, the positions of the first ``k``
True entries, in ascending order. The JAX version contracts a [N, k, S]
one-hot over the sample axis (cheap on the TPU's vector units); here the
same selection is an inclusive cumsum (each live entry's rank) and one
scatter of positions (and values) to ``[n, rank - 1]``: ranks are distinct
within a row, and live entries past ``k`` go to a spare column that is
sliced off.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def keep_first_k(
    live: torch.Tensor, k: int, vals: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, ...]:
    """live [N, S] bool -> (idx [N, k] int32, mask [N, k] bool[, vk [N, k]]).

    ``idx[n, j]`` is the position of the (j+1)-th True in ``live[n]`` (0
    where absent, masked by ``mask``). With ``vals`` [N, S], ``vk`` holds
    the values at the kept positions (0 where absent), as the JAX version's
    contraction gives them."""
    n, s = live.shape
    rank = torch.cumsum(live.to(torch.int32), dim=-1)  # [N, S] inclusive
    slot = torch.where(live & (rank <= k), rank - 1, k).long()  # [N, S]; k = spare column
    pos = torch.arange(s, dtype=torch.int32, device=live.device).expand(n, s)
    idx = torch.zeros(n, k + 1, dtype=torch.int32, device=live.device).scatter_(1, slot, pos)[:, :k]
    mask = torch.arange(1, k + 1, device=live.device)[None, :] <= rank[:, -1:]
    if vals is None:
        return idx, mask
    vk = torch.zeros(n, k + 1, dtype=vals.dtype, device=live.device).scatter_(1, slot, vals)[:, :k]
    return idx, mask, vk
