# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: framework.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




# anakin_tpu_torch: a pool of the port's own, so that this copy and the
# JAX package's (the same file name and package) load in one process
_POOL = _descriptor_pool.DescriptorPool()
DESCRIPTOR = _POOL.AddSerializedFile(b'\n\x0f\x66ramework.proto\x12\x0c\x61nakin_fluid\"\xe7\x03\n\x06OpDesc\x12(\n\x06inputs\x18\x01 \x03(\x0b\x32\x18.anakin_fluid.OpDesc.Var\x12)\n\x07outputs\x18\x02 \x03(\x0b\x32\x18.anakin_fluid.OpDesc.Var\x12\x0c\n\x04type\x18\x03 \x02(\t\x12(\n\x05\x61ttrs\x18\x04 \x03(\x0b\x32\x19.anakin_fluid.OpDesc.Attr\x12\x18\n\tis_target\x18\x05 \x01(\x08:\x05\x66\x61lse\x1a\x88\x02\n\x04\x41ttr\x12\x0c\n\x04name\x18\x01 \x02(\t\x12$\n\x04type\x18\x02 \x02(\x0e\x32\x16.anakin_fluid.AttrType\x12\t\n\x01i\x18\x03 \x01(\x05\x12\t\n\x01\x66\x18\x04 \x01(\x02\x12\t\n\x01s\x18\x05 \x01(\t\x12\x0c\n\x04ints\x18\x06 \x03(\x05\x12\x0e\n\x06\x66loats\x18\x07 \x03(\x02\x12\x0f\n\x07strings\x18\x08 \x03(\t\x12\t\n\x01\x62\x18\n \x01(\x08\x12\r\n\x05\x62ools\x18\x0b \x03(\x08\x12\x11\n\tblock_idx\x18\x0c \x01(\x05\x12\t\n\x01l\x18\r \x01(\x03\x12\x12\n\nblocks_idx\x18\x0e \x03(\x05\x12\r\n\x05longs\x18\x0f \x03(\x03\x12\x10\n\x08\x66loat64s\x18\x10 \x03(\x01\x12\x0f\n\x07\x66loat64\x18\x14 \x01(\x01\x1a+\n\x03Var\x12\x11\n\tparameter\x18\x01 \x02(\t\x12\x11\n\targuments\x18\x02 \x03(\t\"\xf6\x07\n\x07VarType\x12(\n\x04type\x18\x01 \x02(\x0e\x32\x1a.anakin_fluid.VarType.Type\x12\x37\n\rselected_rows\x18\x02 \x01(\x0b\x32 .anakin_fluid.VarType.TensorDesc\x12\x37\n\nlod_tensor\x18\x03 \x01(\x0b\x32#.anakin_fluid.VarType.LoDTensorDesc\x12>\n\x0ctensor_array\x18\x04 \x01(\x0b\x32(.anakin_fluid.VarType.LoDTensorArrayDesc\x12\x30\n\x06reader\x18\x05 \x01(\x0b\x32 .anakin_fluid.VarType.ReaderDesc\x12*\n\x05tuple\x18\x07 \x01(\x0b\x32\x1b.anakin_fluid.VarType.Tuple\x1aI\n\nTensorDesc\x12-\n\tdata_type\x18\x01 \x02(\x0e\x32\x1a.anakin_fluid.VarType.Type\x12\x0c\n\x04\x64ims\x18\x02 \x03(\x03\x1aW\n\rLoDTensorDesc\x12\x30\n\x06tensor\x18\x01 \x02(\x0b\x32 .anakin_fluid.VarType.TensorDesc\x12\x14\n\tlod_level\x18\x02 \x01(\x05:\x01\x30\x1a\\\n\x12LoDTensorArrayDesc\x12\x30\n\x06tensor\x18\x01 \x02(\x0b\x32 .anakin_fluid.VarType.TensorDesc\x12\x14\n\tlod_level\x18\x02 \x01(\x05:\x01\x30\x1a\x45\n\nReaderDesc\x12\x37\n\nlod_tensor\x18\x01 \x03(\x0b\x32#.anakin_fluid.VarType.LoDTensorDesc\x1a\x39\n\x05Tuple\x12\x30\n\x0c\x65lement_type\x18\x01 \x03(\x0e\x32\x1a.anakin_fluid.VarType.Type\"\xac\x02\n\x04Type\x12\x08\n\x04\x42OOL\x10\x00\x12\t\n\x05INT16\x10\x01\x12\t\n\x05INT32\x10\x02\x12\t\n\x05INT64\x10\x03\x12\x08\n\x04\x46P16\x10\x04\x12\x08\n\x04\x46P32\x10\x05\x12\x08\n\x04\x46P64\x10\x06\x12\x0e\n\nLOD_TENSOR\x10\x07\x12\x11\n\rSELECTED_ROWS\x10\x08\x12\x12\n\x0e\x46\x45\x45\x44_MINIBATCH\x10\t\x12\x0e\n\nFETCH_LIST\x10\n\x12\x0f\n\x0bSTEP_SCOPES\x10\x0b\x12\x12\n\x0eLOD_RANK_TABLE\x10\x0c\x12\x14\n\x10LOD_TENSOR_ARRAY\x10\r\x12\x0e\n\nPLACE_LIST\x10\x0e\x12\n\n\x06READER\x10\x0f\x12\x07\n\x03RAW\x10\x11\x12\t\n\x05TUPLE\x10\x12\x12\n\n\x06SIZE_T\x10\x13\x12\t\n\x05UINT8\x10\x14\x12\x08\n\x04INT8\x10\x15\x12\x08\n\x04\x42\x46\x31\x36\x10\x16\"X\n\x07VarDesc\x12\x0c\n\x04name\x18\x01 \x02(\t\x12#\n\x04type\x18\x02 \x02(\x0b\x32\x15.anakin_fluid.VarType\x12\x1a\n\x0bpersistable\x18\x03 \x01(\x08:\x05\x66\x61lse\"\x93\x01\n\tBlockDesc\x12\x0b\n\x03idx\x18\x01 \x02(\x05\x12\x12\n\nparent_idx\x18\x02 \x02(\x05\x12#\n\x04vars\x18\x03 \x03(\x0b\x32\x15.anakin_fluid.VarDesc\x12!\n\x03ops\x18\x04 \x03(\x0b\x32\x14.anakin_fluid.OpDesc\x12\x1d\n\x11\x66orward_block_idx\x18\x05 \x01(\x05:\x02-1\"\x89\x01\n\x0bProgramDesc\x12\'\n\x06\x62locks\x18\x01 \x03(\x0b\x32\x17.anakin_fluid.BlockDesc\x12\x32\n\x07version\x18\x04 \x01(\x0b\x32!.anakin_fluid.ProgramDesc.Version\x1a\x1d\n\x07Version\x12\x12\n\x07version\x18\x01 \x01(\x03:\x01\x30*\xc2\x01\n\x08\x41ttrType\x12\x07\n\x03INT\x10\x00\x12\t\n\x05\x46LOAT\x10\x01\x12\n\n\x06STRING\x10\x02\x12\x08\n\x04INTS\x10\x03\x12\n\n\x06\x46LOATS\x10\x04\x12\x0b\n\x07STRINGS\x10\x05\x12\x0b\n\x07\x42OOLEAN\x10\x06\x12\x0c\n\x08\x42OOLEANS\x10\x07\x12\t\n\x05\x42LOCK\x10\x08\x12\x08\n\x04LONG\x10\t\x12\n\n\x06\x42LOCKS\x10\n\x12\t\n\x05LONGS\x10\x0b\x12\x0c\n\x08\x46LOAT64S\x10\x0c\x12\x07\n\x03VAR\x10\r\x12\x08\n\x04VARS\x10\x0e\x12\x0b\n\x07\x46LOAT64\x10\x0f')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'framework_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _ATTRTYPE._serialized_start=1921
  _ATTRTYPE._serialized_end=2115
  _OPDESC._serialized_start=34
  _OPDESC._serialized_end=521
  _OPDESC_ATTR._serialized_start=212
  _OPDESC_ATTR._serialized_end=476
  _OPDESC_VAR._serialized_start=478
  _OPDESC_VAR._serialized_end=521
  _VARTYPE._serialized_start=524
  _VARTYPE._serialized_end=1538
  _VARTYPE_TENSORDESC._serialized_start=849
  _VARTYPE_TENSORDESC._serialized_end=922
  _VARTYPE_LODTENSORDESC._serialized_start=924
  _VARTYPE_LODTENSORDESC._serialized_end=1011
  _VARTYPE_LODTENSORARRAYDESC._serialized_start=1013
  _VARTYPE_LODTENSORARRAYDESC._serialized_end=1105
  _VARTYPE_READERDESC._serialized_start=1107
  _VARTYPE_READERDESC._serialized_end=1176
  _VARTYPE_TUPLE._serialized_start=1178
  _VARTYPE_TUPLE._serialized_end=1235
  _VARTYPE_TYPE._serialized_start=1238
  _VARTYPE_TYPE._serialized_end=1538
  _VARDESC._serialized_start=1540
  _VARDESC._serialized_end=1628
  _BLOCKDESC._serialized_start=1631
  _BLOCKDESC._serialized_end=1778
  _PROGRAMDESC._serialized_start=1781
  _PROGRAMDESC._serialized_end=1918
  _PROGRAMDESC_VERSION._serialized_start=1889
  _PROGRAMDESC_VERSION._serialized_end=1918
# @@protoc_insertion_point(module_scope)
