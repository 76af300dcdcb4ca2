"""Tools over the port: the model converters (`tools.converter`), the
int8-vs-fp32 accuracy harness (`tools.accuracy`) and the kernel-variant
builder (`tools.kernel_variants`, on the machine with the card)."""
