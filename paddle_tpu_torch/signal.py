"""paddle.signal (`paddle_tpu/signal.py`; reference `python/paddle/signal.py`,
the frame / overlap_add / stft ops in ops.yaml) over strided windows and
`torch.fft`.

The formulas are the JAX package's: centring pads n_fft // 2 on each side
with `pad_mode`, a window shorter than n_fft is zero-padded to it in the
middle, `normalized` scales by 1/sqrt(n_fft), `onesided` keeps the rfft
half, and istft divides the overlap-added frames by the overlap-added
squared window (floored at 1e-11). Everything runs where its input lies,
so a CUDA signal is framed and transformed on the card.
"""

import torch

from paddle_tpu_torch.core.tensor import Tensor, apply

__all__ = ["frame", "overlap_add", "stft", "istft"]


def _frame_data(a, frame_length, hop_length, axis=-1):
    """Reference layout (`python/paddle/signal.py` frame): axis=-1 maps
    (..., seq) -> (..., frame_length, n_frames); axis=0 maps (seq, ...) ->
    (n_frames, frame_length, ...). Only these two axes are supported, as in
    the reference."""
    if axis not in (0, -1, a.dim() - 1):
        raise ValueError("frame: axis must be 0 or -1")
    if axis == 0:
        a = torch.movedim(a, 0, -1)
    out = a.unfold(-1, frame_length, hop_length)   # [..., n_frames, fl]
    if axis == 0:
        return torch.movedim(out, (-2, -1), (0, 1))  # [n_frames, fl, ...]
    return out.transpose(-1, -2)  # [..., frame_length, n_frames]


def frame(x, frame_length, hop_length, axis=-1, name=None):
    """Slice into overlapping frames (reference ops.yaml frame)."""
    return apply(lambda a: _frame_data(a, frame_length, hop_length, axis), x,
                 _name="frame")


def _overlap_add(frames, hop_length):
    """[..., n_frames, fl] -> [..., (n_frames - 1) * hop + fl], each frame
    added at its offset."""
    num, fl = frames.shape[-2], frames.shape[-1]
    n = (num - 1) * hop_length + fl
    idx = (torch.arange(num, device=frames.device)[:, None] * hop_length
           + torch.arange(fl, device=frames.device)[None, :]).reshape(-1)
    lead = frames.shape[:-2]
    out = frames.new_zeros(lead + (n,))
    return out.index_add(-1, idx, frames.reshape(lead + (num * fl,)))


def overlap_add(x, hop_length, axis=-1, name=None):
    """Inverse of frame (ops.yaml overlap_add). Reference layouts: axis=-1
    takes [..., frame_length, n_frames]; axis=0 takes
    [n_frames, frame_length, ...]."""
    if axis not in (0, -1):
        raise ValueError("overlap_add: axis must be 0 or -1")

    def fn(a):
        if axis == 0:
            frames = torch.movedim(a, (0, 1), (-2, -1))  # [..., n_frames, fl]
        else:
            frames = a.transpose(-1, -2)  # [..., n_frames, fl]
        out = _overlap_add(frames, hop_length)
        if axis == 0:
            out = torch.movedim(out, -1, 0)
        return out

    return apply(fn, x, _name="overlap_add")


def _window(win, win_length, n_fft, dtype, device):
    w = (torch.ones((win_length,), dtype=dtype, device=device) if win is None
         else torch.as_tensor(win, device=device))
    if win_length < n_fft:
        lpad = (n_fft - win_length) // 2
        w = torch.nn.functional.pad(w, (lpad, n_fft - win_length - lpad))
    return w


def stft(x, n_fft, hop_length=None, win_length=None, window=None,
         center=True, pad_mode="reflect", normalized=False, onesided=True,
         name=None):
    """Short-time Fourier transform (reference signal.py stft):
    [..., seq] -> [..., freq, n_frames] complex."""
    hop_length = hop_length or n_fft // 4
    win_length = win_length or n_fft
    win = window._data if isinstance(window, Tensor) else window

    def fn(a):
        w = _window(win, win_length, n_fft, a.dtype, a.device)
        if center:
            pad = n_fft // 2
            lead = a.shape[:-1]
            # torch pads the last dim of a batched [N, 1, seq] input
            flat = a.reshape((-1, 1, a.shape[-1]))
            flat = torch.nn.functional.pad(flat, (pad, pad), mode=pad_mode)
            a = flat.reshape(lead + (flat.shape[-1],))
        frames = a.unfold(-1, n_fft, hop_length) * w   # [..., num, n_fft]
        spec = (torch.fft.rfft(frames) if onesided
                else torch.fft.fft(frames))
        if normalized:
            spec = spec / torch.sqrt(torch.tensor(
                float(n_fft), dtype=spec.real.dtype))
        return spec.transpose(-1, -2)  # [..., freq, num_frames]

    return apply(fn, x, _name="stft")


def istft(x, n_fft, hop_length=None, win_length=None, window=None,
          center=True, normalized=False, onesided=True, length=None,
          return_complex=False, name=None):
    """Inverse of stft (reference signal.py istft): [..., freq, n_frames]
    -> [..., seq]."""
    hop_length = hop_length or n_fft // 4
    win_length = win_length or n_fft
    win = window._data if isinstance(window, Tensor) else window

    def fn(s):
        w = _window(win, win_length, n_fft, torch.float32, s.device)
        spec = s.transpose(-1, -2)  # [..., num, freq]
        if normalized:
            spec = spec * torch.sqrt(torch.tensor(float(n_fft)))
        frames = (torch.fft.irfft(spec, n=n_fft) if onesided
                  else torch.fft.ifft(spec).real)
        frames = frames * w
        num = frames.shape[-2]
        n = (num - 1) * hop_length + n_fft
        out = _overlap_add(frames, hop_length)
        # window envelope normalization (COLA)
        env = _overlap_add((w * w).to(frames.dtype).expand(num, n_fft),
                           hop_length)
        out = out / torch.clamp(env, min=1e-11)
        if center:
            out = out[..., n_fft // 2: n - n_fft // 2]
        if length is not None:
            out = out[..., :length]
        return out

    return apply(fn, x, _name="istft")
