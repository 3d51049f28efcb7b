"""Model hosting layer (port of ``magent_tpu/model.py``).

``BaseModel`` is the reference model contract (reference:
python/magent/model.py:14-66).  ``ProcessingModel`` keeps the reference's
non-blocking ``infer_action``/``sample_step``/``train`` API (reference:
model.py:115-285) but hosts the model in-process: the env and the policies
share one device, and PyTorch's asynchronous launches already overlap a
group's inference with the host work around it.  ``SubprocessModel`` hosts
it behind a real pipe, as the reference did.

Models take NumPy and give NumPy: observations, ids, rewards and actions
cross this layer (and the pipe) as arrays, never as tensors.
"""

from __future__ import annotations

import numpy as np

from .utility import EpisodesBuffer


class BaseModel:
    def __init__(self, env, handle, *args, **kwargs):
        """Init a model of a group of agents in an environment."""
        self.env = env
        self.handle = handle

    def infer_action(self, raw_obs, ids, *args, **kwargs):
        """Infer actions for the given observations.

        Parameters
        ----------
        raw_obs: tuple(numpy array, numpy array)
            (views, features)
        ids: numpy array of int32
            agent ids

        Returns
        -------
        actions: numpy array of int32
        """
        raise NotImplementedError

    def train(self, sample_buffer, **kwargs):
        """Feed new samples and train; returns loss and estimated mean state
        value."""
        return 0, 0

    def save(self, *args, **kwargs):
        raise NotImplementedError

    def load(self, *args, **kwargs):
        raise NotImplementedError


class ProcessingModel(BaseModel):
    """Non-blocking facade over an in-process model.

    Signature of the reference (model.py:115-155): ``ProcessingModel(env,
    handle, name, port, sample_buffer_capacity, RLModel, **kwargs)``;
    ``port`` is accepted for compatibility and ignored (no pipe), and
    ``kwargs`` go to ``RLModel`` (``device`` among them: ``None`` is the
    card).
    """

    def __init__(self, env, handle, name, port=0, sample_buffer_capacity=1000,
                 RLModel=None, **kwargs):
        super().__init__(env, handle)
        assert RLModel is not None
        self.name = name
        self.model = RLModel(env, handle, name, **kwargs)
        self.sample_buffer = EpisodesBuffer(capacity=sample_buffer_capacity)
        self._pending_action = None
        self._pending_train = None
        self._last_obs = None
        self._last_ids = None
        self._last_acts = None

    # ------------------------------------------------------------- inference
    def infer_action(self, raw_obs, ids, policy='e_greedy', eps=0, block=True):
        self._last_obs = raw_obs
        self._last_ids = ids
        self._last_acts = self.model.infer_action(raw_obs, ids, policy=policy,
                                                  eps=eps)
        self._pending_action = self._last_acts
        if block:
            return self.fetch_action()
        return None

    def fetch_action(self):
        act = self._pending_action
        self._pending_action = None
        return act

    # -------------------------------------------------------------- sampling
    def sample_step(self, rewards, alives, block=True):
        if self._last_acts is None:
            raise RuntimeError("sample_step before infer_action")
        self.sample_buffer.record_step(
            self._last_ids, self._last_obs, self._last_acts, rewards, alives
        )
        self._last_acts = None  # a duplicate sample must not re-record

    def fetch_sample(self):
        return None

    def check_done(self):
        return None

    # -------------------------------------------------------------- training
    def train(self, print_every=5000, block=True, **kwargs):
        self._pending_train = self.model.train(
            self.sample_buffer, print_every=print_every, **kwargs
        )
        self.sample_buffer = EpisodesBuffer(self.sample_buffer.capacity)
        if block:
            return self._pending_train
        return None

    def fetch_train(self):
        res = self._pending_train
        self._pending_train = None
        return res

    # ------------------------------------------------------------ checkpoint
    def save(self, save_dir, epoch):
        self.model.save(save_dir, epoch)

    def load(self, save_dir, epoch, name=None):
        self.model.load(save_dir, epoch, name)

    def quit(self):
        pass


# --------------------------------------------------------- subprocess hosting
_CHUNK_BYTES = 1 << 28  # pipe segments: 256MB of raw bytes per message


def _send_arrays(conn, arrays):
    """Ship numpy arrays over a Connection: one picklable header (shapes +
    dtypes), then each array's raw bytes in fixed-size segments.  Large
    buffers never go through pickle, and tensors never cross: every operand
    is a NumPy array (``np.asarray`` of a CUDA tensor raises)."""
    arrays = [np.ascontiguousarray(a) for a in arrays]
    conn.send([(a.shape, a.dtype.str) for a in arrays])
    for a in arrays:
        view = memoryview(a).cast("B")
        if len(view) == 0:
            conn.send_bytes(b"")
            continue
        for off in range(0, len(view), _CHUNK_BYTES):
            conn.send_bytes(view[off : off + _CHUNK_BYTES])


def _recv_arrays(conn):
    out = []
    for shape, dtype in conn.recv():
        n_bytes = int(np.prod(shape)) * np.dtype(dtype).itemsize
        buf = bytearray(n_bytes)
        if n_bytes == 0:
            conn.recv_bytes()  # the sender's placeholder segment
        else:
            view = memoryview(buf)
            off = 0
            while off < n_bytes:
                off += conn.recv_bytes_into(view[off:])
        out.append(np.frombuffer(buf, dtype=dtype).reshape(shape))
    return out


class _SpaceStub:
    """Picklable stand-in for the env inside a model worker: models only
    read the group's spaces at construction time."""

    def __init__(self, view_space, feature_space, action_space):
        self._view = view_space
        self._feature = feature_space
        self._action = action_space

    def get_view_space(self, handle):
        return self._view

    def get_feature_space(self, handle):
        return self._feature

    def get_action_space(self, handle):
        return self._action


def _model_worker(conn, buffer_capacity, RLModel, model_args):
    """Subprocess body hosting one model behind the command pipe.

    Commands arrive as ``(name, payload)`` tuples; array operands travel as
    raw byte segments (:func:`_send_arrays`).  The model is built here, so a
    CUDA model initializes CUDA in this process (``model_args["device"]``,
    ``None`` for the card).
    """
    model = RLModel(**model_args)
    buffer = EpisodesBuffer(capacity=buffer_capacity)
    last = {}

    while True:
        cmd, payload = conn.recv()
        if cmd == "act":
            policy, eps = payload
            view, feature, ids = _recv_arrays(conn)
            acts = model.infer_action((view, feature), ids, policy=policy,
                                      eps=eps)
            last = dict(obs=(view, feature), ids=ids, acts=acts)
            _send_arrays(conn, [np.asarray(acts)])
        elif cmd == "sample":
            rewards, alives = _recv_arrays(conn)
            if not last:
                # protocol misuse ('sample' with no 'act' since the last
                # sample): report it instead of KeyError-ing the worker and
                # leaving the parent blocked on a dead pipe
                conn.send(("err", "sample before act"))
            else:
                buffer.record_step(last["ids"], last["obs"], last["acts"],
                                   rewards, alives)
                last = {}  # a second 'sample' must not re-record this step
                conn.send(("ok", None))
        elif cmd == "train":
            print_every, extra = payload
            result = model.train(buffer, print_every=print_every, **extra)
            buffer = EpisodesBuffer(capacity=buffer_capacity)
            conn.send(("ok", result))
        elif cmd == "save":
            model.save(*payload)
            conn.send(("ok", None))
        elif cmd == "load":
            model.load(*payload)
            conn.send(("ok", None))
        elif cmd == "quit":
            conn.close()
            return
        else:
            # reply instead of looping silently: a silent fall-through would
            # deadlock the parent's pending recv
            conn.send(("err", "unknown command %r" % (cmd,)))


class SubprocessModel(BaseModel):
    """Cross-process model hosting with the reference's non-blocking facade
    over a real pipe (reference: python/magent/model.py:115-347), on a
    ``(command, payload)`` protocol with segmented raw-byte array transport.

    The worker is a ``spawn``-ed process that builds ``RLModel`` itself.
    Where the JAX package's worker takes ``platform`` (``"cpu"`` by
    default, so that the parent keeps the accelerator), this one takes
    ``device``, passed to ``RLModel``: ``None`` is the card, as at every
    entry point of this package, and ``"cpu"`` keeps the worker off it.
    ``quit()`` stops the worker (terminating it if it does not exit within
    10 s).
    """

    def __init__(self, env, handle, name, port=0, sample_buffer_capacity=1000,
                 RLModel=None, device=None, **kwargs):
        import multiprocessing as mp

        super().__init__(env, handle)
        assert RLModel is not None
        self.name = name
        stub = _SpaceStub(env.get_view_space(handle),
                          env.get_feature_space(handle),
                          env.get_action_space(handle))
        model_args = dict(kwargs)
        model_args.update(env=stub, handle=handle, name=name, device=device)

        ctx = mp.get_context("spawn")
        self.conn, child = ctx.Pipe()
        self.proc = ctx.Process(
            target=_model_worker,
            args=(child, sample_buffer_capacity, RLModel, model_args),
            daemon=True,
        )
        self.proc.start()
        child.close()

    def _ack(self):
        status, payload = self.conn.recv()
        if status != "ok":
            raise RuntimeError("model worker error: %s" % (payload,))
        return payload

    # ------------------------------------------------------------- inference
    def infer_action(self, raw_obs, ids, policy="e_greedy", eps=0, block=True):
        self.conn.send(("act", (policy, eps)))
        _send_arrays(self.conn, [np.asarray(raw_obs[0]),
                                 np.asarray(raw_obs[1]), np.asarray(ids)])
        if block:
            return self.fetch_action()
        return None

    def fetch_action(self):
        return _recv_arrays(self.conn)[0]

    # -------------------------------------------------------------- sampling
    def sample_step(self, rewards, alives, block=True):
        self.conn.send(("sample", None))
        _send_arrays(self.conn, [np.asarray(rewards, np.float32),
                                 np.asarray(alives, bool)])
        if block:
            return self.check_done()
        return None

    def fetch_sample(self):
        return self.check_done()

    def check_done(self):
        self._ack()
        return "done"

    # -------------------------------------------------------------- training
    def train(self, print_every=5000, block=True, **kwargs):
        self.conn.send(("train", (print_every, kwargs)))
        if block:
            return self.fetch_train()
        return None

    def fetch_train(self):
        return self._ack()

    # ------------------------------------------------------------ checkpoint
    def save(self, save_dir, epoch):
        self.conn.send(("save", (save_dir, epoch)))
        self._ack()

    def load(self, save_dir, epoch, name=None):
        self.conn.send(("load", (save_dir, epoch, name)))
        self._ack()

    def quit(self):
        try:
            self.conn.send(("quit", None))
        except (BrokenPipeError, OSError):
            pass
        self.proc.join(timeout=10)
        if self.proc.is_alive():
            self.proc.terminate()
            self.proc.join(timeout=10)
        self.conn.close()
