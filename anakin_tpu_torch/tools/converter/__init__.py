from .torch_frontend import from_torch  # noqa: F401


def from_onnx(model):  # lazy: keeps protobuf import off the hot path
    from .onnx_frontend import from_onnx as _f

    return _f(model)


def from_caffe(prototxt, caffemodel=None):
    from .caffe_frontend import from_caffe as _f

    return _f(prototxt, caffemodel)


def from_fluid(model_path, params_path=None, batch_size=1):
    from .fluid_frontend import from_fluid as _f

    return _f(model_path, params_path, batch_size)


def from_tf(pb_path, batch_size=1, outputs=None):
    from .tf_frontend import from_tf as _f

    return _f(pb_path, batch_size, outputs)
