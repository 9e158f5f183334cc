-- DF_CS: catalog channel delete (TPC-DS spec 5.3.11.1).
-- Reference behavior: nds/data_maintenance/DF_CS.sql:30-33.
delete from catalog_returns where cr_order_number in
  (select distinct cs_order_number from catalog_sales, date_dim
   where cs_sold_date_sk = d_date_sk and d_date between date 'DATE1' and date 'DATE2');
delete from catalog_sales
 where cs_sold_date_sk >= (select min(d_date_sk) from date_dim
                           where d_date between date 'DATE1' and date 'DATE2')
   and cs_sold_date_sk <= (select max(d_date_sk) from date_dim
                           where d_date between date 'DATE1' and date 'DATE2');
