"""Multi-layer perceptron in PyTorch (classifier + regressor).

Paper search space (Table 1): hidden width {20..200}, depth {1..10},
activation {identity, logistic, tanh, relu}; tuned result (Table 4):
5 layers x 100 nodes, ReLU, Adam, lr 1e-3, 200 epochs. Training is
full-batch Adam, written out step by step as the reference writes it — the
datasets here are small enough that full-batch is both fast and
deterministic.

Plain functions over a list of ``{"w", "b"}`` tensor dicts, as the
reference's pytree: ``_forward(params, X, act)`` and ``_train(params, X, y,
...)`` take the parameters as arguments. The estimators train on
``device`` (``None`` = the card, raising where there is none) and draw the
He-normal initialisation from a ``torch.Generator`` seeded with ``seed`` on
that device (other numbers than the reference's ``jax.random``; the tests
feed both packages the same initial parameters).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.common import resolve_device
from repro_torch.ml.base import ClassifierMixin, Estimator, RegressorMixin, check_Xy

_ACTIVATIONS = {
    "identity": lambda x: x,
    "logistic": torch.sigmoid,
    "tanh": torch.tanh,
    "relu": torch.relu,
}


def _init_params(generator: torch.Generator, sizes, device) -> list[dict]:
    params = []
    for din, dout in zip(sizes[:-1], sizes[1:]):
        w = torch.randn((din, dout), generator=generator, device=device) * (2.0 / din) ** 0.5
        params.append({"w": w, "b": torch.zeros(dout, device=device)})
    return params


def _forward(params, X, act):
    h = X
    for layer in params[:-1]:
        h = act(h @ layer["w"] + layer["b"])
    last = params[-1]
    return h @ last["w"] + last["b"]


def _loss(params, X, y, act, loss_kind):
    out = _forward(params, X, act)
    if loss_kind == "xent":
        logp = torch.log_softmax(out, dim=-1)
        return -torch.mean(torch.take_along_dim(logp, y[:, None], dim=1))
    return torch.mean((out.squeeze(-1) - y) ** 2)


def _train(params, X, y, *, act_name, loss_kind, epochs, lr):
    """Full-batch Adam (b1 0.9, b2 0.999, eps 1e-8, bias correction by step
    ``t + 1``). Returns (trained params, the loss after each step)."""
    act = _ACTIVATIONS[act_name]
    b1, b2, eps = 0.9, 0.999, 1e-8
    p = [{k: v.detach().clone().requires_grad_(True) for k, v in layer.items()}
         for layer in params]
    leaves = [v for layer in p for v in layer.values()]
    m = [torch.zeros_like(v) for v in leaves]
    v2 = [torch.zeros_like(v) for v in leaves]
    losses = []
    for t in range(epochs):
        loss = _loss(p, X, y, act, loss_kind)
        if t:
            losses.append(loss.detach())  # the loss after the previous step
        grads = torch.autograd.grad(loss, leaves)
        tt = t + 1
        with torch.no_grad():
            for leaf, g, m_, v_ in zip(leaves, grads, m, v2):
                m_.mul_(b1).add_((1 - b1) * g)
                v_.mul_(b2).add_((1 - b2) * g**2)
                mh = m_ / (1 - b1**tt)
                vh = v_ / (1 - b2**tt)
                leaf.sub_(lr * mh / (torch.sqrt(vh) + eps))
    if epochs:
        with torch.no_grad():
            losses.append(_loss(p, X, y, act, loss_kind))
    trained = [{k: v.detach() for k, v in layer.items()} for layer in p]
    empty = torch.zeros(0, device=X.device)
    return trained, torch.stack(losses) if losses else empty


class _BaseMLP(Estimator):
    def __init__(self, hidden_layer_size=100, n_layers=5, activation="relu",
                 learning_rate=1e-3, epochs=200, seed=0, device=None):
        if activation not in _ACTIVATIONS:
            raise ValueError(f"activation must be one of {sorted(_ACTIVATIONS)}")
        self.hidden_layer_size = hidden_layer_size
        self.n_layers = n_layers
        self.activation = activation
        self.learning_rate = learning_rate
        self.epochs = epochs
        self.seed = seed
        self.device = device

    def _fit(self, X, y, out_dim, loss_kind):
        device = resolve_device(self.device)
        self.x_mean_ = X.mean(axis=0)
        self.x_scale_ = np.where(X.std(axis=0) > 0, X.std(axis=0), 1.0)
        Xs = (X - self.x_mean_) / self.x_scale_
        sizes = [X.shape[1]] + [self.hidden_layer_size] * self.n_layers + [out_dim]
        params = _init_params(torch.Generator(device=device).manual_seed(self.seed), sizes,
                              device)
        self.params_, losses = _train(
            params,
            torch.as_tensor(Xs, dtype=torch.float32, device=device),
            torch.as_tensor(y, device=device),
            act_name=self.activation,
            loss_kind=loss_kind,
            epochs=self.epochs,
            lr=self.learning_rate,
        )
        self.loss_curve_ = losses.cpu().numpy()
        return self

    def _raw_predict(self, X):
        X = np.asarray(X, dtype=np.float64)
        Xs = (X - self.x_mean_) / self.x_scale_
        device = self.params_[0]["w"].device
        with torch.no_grad():
            out = _forward(self.params_, torch.as_tensor(Xs, dtype=torch.float32, device=device),
                           _ACTIVATIONS[self.activation])
        return out.cpu().numpy()


class MLPClassifier(_BaseMLP, ClassifierMixin):
    def fit(self, X, y):
        X, y = check_Xy(X, y)
        self.classes_, y_enc = np.unique(y, return_inverse=True)
        return self._fit(X, y_enc.astype(np.int64), len(self.classes_), "xent")

    def predict_proba(self, X):
        out = self._raw_predict(X)
        e = np.exp(out - out.max(axis=1, keepdims=True))
        return e / e.sum(axis=1, keepdims=True)

    def predict(self, X):
        return self.classes_[np.argmax(self._raw_predict(X), axis=1)]


class MLPRegressor(_BaseMLP, RegressorMixin):
    def fit(self, X, y):
        X, y = check_Xy(X, y)
        self.y_mean_ = float(np.mean(y))
        self.y_scale_ = float(np.std(y)) or 1.0
        ys = (y.astype(np.float64) - self.y_mean_) / self.y_scale_
        return self._fit(X, ys.astype(np.float32), 1, "mse")

    def predict(self, X):
        return self._raw_predict(X).squeeze(-1) * self.y_scale_ + self.y_mean_
