"""Tools over the port: the model converters (`tools.converter`) and the
int8-vs-fp32 accuracy harness (`tools.accuracy`)."""
