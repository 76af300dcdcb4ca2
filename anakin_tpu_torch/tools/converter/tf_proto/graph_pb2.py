# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: graph.proto
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
DESCRIPTOR = _POOL.AddSerializedFile(b'\n\x0bgraph.proto\x12\tanakin_tf\"y\n\x10TensorShapeProto\x12,\n\x03\x64im\x18\x02 \x03(\x0b\x32\x1f.anakin_tf.TensorShapeProto.Dim\x12\x14\n\x0cunknown_rank\x18\x03 \x01(\x08\x1a!\n\x03\x44im\x12\x0c\n\x04size\x18\x01 \x01(\x03\x12\x0c\n\x04name\x18\x02 \x01(\t\"\xaf\x02\n\x0bTensorProto\x12\"\n\x05\x64type\x18\x01 \x01(\x0e\x32\x13.anakin_tf.DataType\x12\x31\n\x0ctensor_shape\x18\x02 \x01(\x0b\x32\x1b.anakin_tf.TensorShapeProto\x12\x16\n\x0eversion_number\x18\x03 \x01(\x05\x12\x16\n\x0etensor_content\x18\x04 \x01(\x0c\x12\x15\n\tfloat_val\x18\x05 \x03(\x02\x42\x02\x10\x01\x12\x16\n\ndouble_val\x18\x06 \x03(\x01\x42\x02\x10\x01\x12\x13\n\x07int_val\x18\x07 \x03(\x05\x42\x02\x10\x01\x12\x12\n\nstring_val\x18\x08 \x03(\x0c\x12\x15\n\tint64_val\x18\n \x03(\x03\x42\x02\x10\x01\x12\x14\n\x08\x62ool_val\x18\x0b \x03(\x08\x42\x02\x10\x01\x12\x14\n\x08half_val\x18\r \x03(\x05\x42\x02\x10\x01\"\xcd\x03\n\tAttrValue\x12.\n\x04list\x18\x01 \x01(\x0b\x32\x1e.anakin_tf.AttrValue.ListValueH\x00\x12\x0b\n\x01s\x18\x02 \x01(\x0cH\x00\x12\x0b\n\x01i\x18\x03 \x01(\x03H\x00\x12\x0b\n\x01\x66\x18\x04 \x01(\x02H\x00\x12\x0b\n\x01\x62\x18\x05 \x01(\x08H\x00\x12#\n\x04type\x18\x06 \x01(\x0e\x32\x13.anakin_tf.DataTypeH\x00\x12,\n\x05shape\x18\x07 \x01(\x0b\x32\x1b.anakin_tf.TensorShapeProtoH\x00\x12(\n\x06tensor\x18\x08 \x01(\x0b\x32\x16.anakin_tf.TensorProtoH\x00\x12\x15\n\x0bplaceholder\x18\t \x01(\tH\x00\x1a\xbe\x01\n\tListValue\x12\t\n\x01s\x18\x02 \x03(\x0c\x12\r\n\x01i\x18\x03 \x03(\x03\x42\x02\x10\x01\x12\r\n\x01\x66\x18\x04 \x03(\x02\x42\x02\x10\x01\x12\r\n\x01\x62\x18\x05 \x03(\x08\x42\x02\x10\x01\x12%\n\x04type\x18\x06 \x03(\x0e\x32\x13.anakin_tf.DataTypeB\x02\x10\x01\x12*\n\x05shape\x18\x07 \x03(\x0b\x32\x1b.anakin_tf.TensorShapeProto\x12&\n\x06tensor\x18\x08 \x03(\x0b\x32\x16.anakin_tf.TensorProtoB\x07\n\x05value\"\xb1\x01\n\x07NodeDef\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\n\n\x02op\x18\x02 \x01(\t\x12\r\n\x05input\x18\x03 \x03(\t\x12\x0e\n\x06\x64\x65vice\x18\x04 \x01(\t\x12*\n\x04\x61ttr\x18\x05 \x03(\x0b\x32\x1c.anakin_tf.NodeDef.AttrEntry\x1a\x41\n\tAttrEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12#\n\x05value\x18\x02 \x01(\x0b\x32\x14.anakin_tf.AttrValue:\x02\x38\x01\"K\n\nVersionDef\x12\x10\n\x08producer\x18\x01 \x01(\x05\x12\x14\n\x0cmin_consumer\x18\x02 \x01(\x05\x12\x15\n\rbad_consumers\x18\x03 \x03(\x05\"U\n\x08GraphDef\x12 \n\x04node\x18\x01 \x03(\x0b\x32\x12.anakin_tf.NodeDef\x12\'\n\x08versions\x18\x04 \x01(\x0b\x32\x15.anakin_tf.VersionDef*\xb5\x02\n\x08\x44\x61taType\x12\x0e\n\nDT_INVALID\x10\x00\x12\x0c\n\x08\x44T_FLOAT\x10\x01\x12\r\n\tDT_DOUBLE\x10\x02\x12\x0c\n\x08\x44T_INT32\x10\x03\x12\x0c\n\x08\x44T_UINT8\x10\x04\x12\x0c\n\x08\x44T_INT16\x10\x05\x12\x0b\n\x07\x44T_INT8\x10\x06\x12\r\n\tDT_STRING\x10\x07\x12\x10\n\x0c\x44T_COMPLEX64\x10\x08\x12\x0c\n\x08\x44T_INT64\x10\t\x12\x0b\n\x07\x44T_BOOL\x10\n\x12\x0c\n\x08\x44T_QINT8\x10\x0b\x12\r\n\tDT_QUINT8\x10\x0c\x12\r\n\tDT_QINT32\x10\r\x12\x0f\n\x0b\x44T_BFLOAT16\x10\x0e\x12\r\n\tDT_QINT16\x10\x0f\x12\x0e\n\nDT_QUINT16\x10\x10\x12\r\n\tDT_UINT16\x10\x11\x12\x11\n\rDT_COMPLEX128\x10\x12\x12\x0b\n\x07\x44T_HALF\x10\x13\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'graph_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _TENSORPROTO.fields_by_name['float_val']._options = None
  _TENSORPROTO.fields_by_name['float_val']._serialized_options = b'\020\001'
  _TENSORPROTO.fields_by_name['double_val']._options = None
  _TENSORPROTO.fields_by_name['double_val']._serialized_options = b'\020\001'
  _TENSORPROTO.fields_by_name['int_val']._options = None
  _TENSORPROTO.fields_by_name['int_val']._serialized_options = b'\020\001'
  _TENSORPROTO.fields_by_name['int64_val']._options = None
  _TENSORPROTO.fields_by_name['int64_val']._serialized_options = b'\020\001'
  _TENSORPROTO.fields_by_name['bool_val']._options = None
  _TENSORPROTO.fields_by_name['bool_val']._serialized_options = b'\020\001'
  _TENSORPROTO.fields_by_name['half_val']._options = None
  _TENSORPROTO.fields_by_name['half_val']._serialized_options = b'\020\001'
  _ATTRVALUE_LISTVALUE.fields_by_name['i']._options = None
  _ATTRVALUE_LISTVALUE.fields_by_name['i']._serialized_options = b'\020\001'
  _ATTRVALUE_LISTVALUE.fields_by_name['f']._options = None
  _ATTRVALUE_LISTVALUE.fields_by_name['f']._serialized_options = b'\020\001'
  _ATTRVALUE_LISTVALUE.fields_by_name['b']._options = None
  _ATTRVALUE_LISTVALUE.fields_by_name['b']._serialized_options = b'\020\001'
  _ATTRVALUE_LISTVALUE.fields_by_name['type']._options = None
  _ATTRVALUE_LISTVALUE.fields_by_name['type']._serialized_options = b'\020\001'
  _NODEDEF_ATTRENTRY._options = None
  _NODEDEF_ATTRENTRY._serialized_options = b'8\001'
  _DATATYPE._serialized_start=1264
  _DATATYPE._serialized_end=1573
  _TENSORSHAPEPROTO._serialized_start=26
  _TENSORSHAPEPROTO._serialized_end=147
  _TENSORSHAPEPROTO_DIM._serialized_start=114
  _TENSORSHAPEPROTO_DIM._serialized_end=147
  _TENSORPROTO._serialized_start=150
  _TENSORPROTO._serialized_end=453
  _ATTRVALUE._serialized_start=456
  _ATTRVALUE._serialized_end=917
  _ATTRVALUE_LISTVALUE._serialized_start=718
  _ATTRVALUE_LISTVALUE._serialized_end=908
  _NODEDEF._serialized_start=920
  _NODEDEF._serialized_end=1097
  _NODEDEF_ATTRENTRY._serialized_start=1032
  _NODEDEF_ATTRENTRY._serialized_end=1097
  _VERSIONDEF._serialized_start=1099
  _VERSIONDEF._serialized_end=1174
  _GRAPHDEF._serialized_start=1176
  _GRAPHDEF._serialized_end=1261
# @@protoc_insertion_point(module_scope)
